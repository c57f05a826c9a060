"""Keccak-256 (the Ethereum/Stone variant, 0x01 domain padding).

Counterpart of ``lambda_elliptic_curves_tpu/hashes/keccak.py``:

* **host**: Keccak-256 of a byte string for transcripts and Merkle path
  checks, through the native C library (``native.host_keccak``); the
  pure-Python sponge :func:`sponge_host` is kept as the oracle;
* **tensor**: batched keccak-f[1600] over ``(25, 2, *B)`` int32 words
  (each 64-bit lane split into its low and high word) and the batched
  fixed-length sponge over ``(W, *B)`` message words.  On a CUDA tensor
  they launch kernel 2 (``csrc/keccak.cu``, which replaces the Pallas
  kernel of ``hashes/keccak_pallas.py``); on a CPU tensor they run the
  plain versions beside it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import native

RATE_BYTES = 136  # keccak-256 rate (1088 bits)
DIGEST_BYTES = 32

_ROUND_CONSTANTS = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)

# rotation offsets r[x][y] (standard Keccak rho table, indexed [x][y])
_ROTATIONS = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)


# ---------------------------------------------------------------------------
# host path
# ---------------------------------------------------------------------------

def _rotl64(x: int, n: int) -> int:
    n %= 64
    return ((x << n) | (x >> (64 - n))) & 0xFFFFFFFFFFFFFFFF


def _keccak_f_host(lanes):
    """lanes: list of 25 ints (index x + 5*y)."""
    for rc in _ROUND_CONSTANTS:
        c = [lanes[x] ^ lanes[x + 5] ^ lanes[x + 10] ^ lanes[x + 15] ^ lanes[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        lanes = [lanes[i] ^ d[i % 5] for i in range(25)]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(
                    lanes[x + 5 * y], _ROTATIONS[x][y]
                )
        lanes = [
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y])
            for y in range(5) for x in range(5)
        ]
        lanes[0] ^= rc
    return lanes


def keccak256(data: bytes) -> bytes:
    """Keccak-256 of a byte string (NOT sha3-256: pad byte is 0x01), by the
    native C implementation."""
    out = ctypes.create_string_buffer(32)
    native.host_keccak().lw_keccak256(bytes(data), len(data), out)
    return out.raw


def _keccak256_py(data: bytes) -> bytes:
    return sponge_host(data, RATE_BYTES, 0x01, DIGEST_BYTES)


def sponge_host(data: bytes, rate: int, pad_byte: int, digest_bytes: int) -> bytes:
    """Generic Keccak-family sponge in pure Python (the oracle): Keccak-256/
    512 (pad 0x01) and NIST SHA3-256/512 (pad 0x06) differ only in rate and
    domain padding."""
    lanes = [0] * 25
    padded = bytearray(data)
    padded.append(pad_byte)
    while len(padded) % rate:
        padded.append(0x00)
    padded[-1] ^= 0x80
    for block_start in range(0, len(padded), rate):
        block = padded[block_start: block_start + rate]
        for i in range(rate // 8):
            lanes[i] ^= int.from_bytes(block[8 * i: 8 * i + 8], "little")
        lanes = _keccak_f_host(lanes)
    out = b"".join(lane.to_bytes(8, "little") for lane in lanes[: (digest_bytes + 7) // 8])
    return out[:digest_bytes]


# ---------------------------------------------------------------------------
# plain tensor path: 64-bit lanes in int64, one round as whole-state ops
# ---------------------------------------------------------------------------

def _i64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _i32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v


def _pi_source() -> list:
    """src[dst]: rho-pi sends lane x + 5y to y + 5*((2x + 3y) % 5)."""
    src = [0] * 25
    for x in range(5):
        for y in range(5):
            src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    return src


_PI_SRC = _pi_source()
_ROT_FLAT = [_ROTATIONS[i % 5][i // 5] for i in range(25)]  # lane x + 5y


def _rotl(x: torch.Tensor, n) -> torch.Tensor:
    """64-bit rotate of int64 lanes; ``n`` an int or an int64 tensor."""
    one = torch.ones_like(n) if torch.is_tensor(n) else 1
    low = (x >> (64 - n)) & ((one << n) - 1)  # logical shift, 0 when n == 0
    return (x << n) | low


def keccak_f_plain(state: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 2's permutation: state ``(25, 2, *B)`` int32,
    ``[i, 0]`` the low and ``[i, 1]`` the high word of lane i."""
    batch = state.shape[2:]
    dev = state.device
    s = (state[:, 0].to(torch.int64) & 0xFFFFFFFF) | (state[:, 1].to(torch.int64) << 32)
    s = s.reshape(25, -1)
    rot = torch.tensor(_ROT_FLAT, dtype=torch.int64, device=dev).reshape(25, 1)
    pi = torch.tensor(_PI_SRC, dtype=torch.int64, device=dev)
    for rc in _ROUND_CONSTANTS:
        g = s.reshape(5, 5, -1)  # [y][x]
        c = g[0] ^ g[1] ^ g[2] ^ g[3] ^ g[4]
        d = torch.roll(c, 1, 0) ^ _rotl(torch.roll(c, -1, 0), 1)
        s = (g ^ d.unsqueeze(0)).reshape(25, -1)
        b = torch.index_select(_rotl(s, rot), 0, pi).reshape(5, 5, -1)
        s = (b ^ (~torch.roll(b, -1, 1) & torch.roll(b, -2, 1))).reshape(25, -1)
        s[0] ^= _i64(rc)
    lo = s.to(torch.int32)
    hi = (s >> 32).to(torch.int32)
    return torch.stack([lo, hi], dim=1).reshape((25, 2) + tuple(batch))


def _sponge(words: torch.Tensor, msg_bytes: int, rate: int, pad_byte: int,
            digest_bytes: int, permute) -> torch.Tensor:
    batch = tuple(words.shape[1:])
    rate_words = rate // 4
    nblocks = msg_bytes // rate + 1
    padded_words = nblocks * rate_words
    msg_words = -(-msg_bytes // 4)
    full = torch.zeros((padded_words,) + batch, dtype=torch.int32, device=words.device)
    full[:msg_words] = words[:msg_words]
    full[msg_bytes // 4] ^= _i32(pad_byte << (8 * (msg_bytes % 4)))
    full[padded_words - 1] ^= _i32(0x80 << 24)
    state = torch.zeros((25, 2) + batch, dtype=torch.int32, device=words.device)
    lanes = rate // 8
    for blk in range(nblocks):
        block = full[blk * rate_words:(blk + 1) * rate_words].reshape((lanes, 2) + batch)
        state = torch.cat([state[:lanes] ^ block, state[lanes:]], dim=0)
        state = permute(state)
    nl = (digest_bytes + 7) // 8
    return state[:nl].reshape((2 * nl,) + batch)[: digest_bytes // 4]


def keccak256_words_plain(words: torch.Tensor, msg_bytes: int) -> torch.Tensor:
    """Plain version of kernel 2's sponge entry."""
    return _sponge(words, int(msg_bytes), RATE_BYTES, 0x01, 32, keccak_f_plain)


# ---------------------------------------------------------------------------
# kernel 2 wrappers (csrc/keccak.cu) and the public tensor API
# ---------------------------------------------------------------------------

def _check_cuda(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dtype != torch.int32 or not x.is_cuda:
        raise TypeError(f"{what} takes int32 CUDA tensors")
    return x.contiguous()


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """Batched keccak-f[1600]: state ``(25, 2, *B)`` int32 words."""
    if state.device.type == "cpu":
        return keccak_f_plain(state)
    st = _check_cuda(state, "keccak_f")
    out = torch.empty_like(st)
    B = st[0, 0].numel()
    if B == 0:
        return out
    native.launch("keccak", "lw_keccak_f", st.data_ptr(), out.data_ptr(), B)
    return out


def keccak256_words(words: torch.Tensor, msg_bytes: int) -> torch.Tensor:
    """Batched Keccak-256 of fixed-size messages.

    ``words``: (W, *B) int32, the messages as little-endian 32-bit words
    (W*4 >= msg_bytes; bytes past the message in the last word are zero).
    Returns (8, *B) int32: the 32-byte digests as little-endian words."""
    msg_bytes = int(msg_bytes)
    if words.device.type == "cpu":
        return keccak256_words_plain(words, msg_bytes)
    w = _check_cuda(words, "keccak256_words")
    if w.shape[0] * 4 < msg_bytes:
        raise ValueError("fewer words than message bytes")
    batch = tuple(w.shape[1:])
    out = torch.empty((8,) + batch, dtype=torch.int32, device=w.device)
    B = w[0].numel()
    if B == 0:
        return out
    native.launch("keccak", "lw_keccak256_words", w.data_ptr(), w.shape[0], B,
                  msg_bytes, out.data_ptr())
    return out


def sponge_words(words: torch.Tensor, msg_bytes: int, rate: int, pad_byte: int,
                 digest_bytes: int) -> torch.Tensor:
    """Batched generic Keccak-family sponge over :func:`keccak_f` (rate and
    padding vary, the permutation doesn't).  Same word layout contract as
    :func:`keccak256_words`; returns (digest_bytes/4, *B) words."""
    return _sponge(words, int(msg_bytes), int(rate), int(pad_byte),
                   int(digest_bytes), keccak_f)


def digest_words_to_bytes(words: torch.Tensor) -> list:
    """(8, B) int32 little-endian digest words -> list of 32-byte digests."""
    arr = words.detach().to("cpu").numpy().reshape(8, -1)
    buf = np.ascontiguousarray(arr.T).astype("<i4").tobytes()
    return [buf[32 * b: 32 * b + 32] for b in range(arr.shape[1])]
