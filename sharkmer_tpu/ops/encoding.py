"""2-bit DNA encoding and vectorised canonical k-mer extraction.

Semantics match the reference hot path ``kmers_from_ascii``
(/root/reference/src/kmer/encoding.rs:332-371):

* A=00, C=01, G=10, T=11; a k-mer occupies the low 2k bits of a u64.
* The canonical form of a k-mer is ``min(kmer, revcomp(kmer))``.
* ``N`` splits the sequence: no window spanning an N emits a k-mer.
* k must be in 1..=31 (2k bits must fit a u64 with headroom for the
  sentinel).

Two independent implementations are kept permanently, copying the
reference's dual-path testing pattern (encoding.rs:4-23):

* ``canonical_kmers`` — the production path: a jit-compiled window
  encoder over fixed-width uint8 code batches ``[n_reads, width]``.
  Instead of the reference's sequential rolling frame (a loop-carried
  dependency), each output position is built by OR-ing k statically
  shifted slices of the code array — k vector ops over the whole
  batch, fully parallel, no sequential scan. The frames are assembled
  in u32 *planes* (plane-wise construction + a lexicographic plane
  compare); only the final canonical assembly is u64.
* ``kmers_from_ascii_ref`` — a tiny pure-Python rolling reference used
  only by tests to cross-check the device path bit-for-bit.
"""

from __future__ import annotations

import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np

BASE_A, BASE_C, BASE_G, BASE_T = 0, 1, 2, 3
CODE_N = 4  # splits windows, counts as invalid
CODE_PAD = 5  # right-padding of fixed-width batches, invalid
KMER_SENTINEL = np.uint64(0xFFFF_FFFF_FFFF_FFFF)  # impossible k-mer (k <= 31)

_ASCII_TO_CODE = np.full(256, 255, dtype=np.uint8)
_ASCII_TO_CODE[ord("A")] = BASE_A
_ASCII_TO_CODE[ord("C")] = BASE_C
_ASCII_TO_CODE[ord("G")] = BASE_G
_ASCII_TO_CODE[ord("T")] = BASE_T
_ASCII_TO_CODE[ord("N")] = CODE_N

_CODE_TO_BASE = "ACGTN"


def _check_k(k: int) -> None:
    if not (0 < k < 32):
        raise ValueError(f"k must be between 1 and 31, got {k}")


def ascii_to_codes(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes (A/C/G/T -> 0..3, N -> 4).

    Raises ValueError on characters outside ACGTN, matching the
    reference's error behaviour (encoding.rs:353-357).
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = _ASCII_TO_CODE[raw]
    if codes.max(initial=0) == 255:
        bad = chr(raw[int(np.argmax(codes == 255))])
        raise ValueError(
            f"Invalid character '{bad}' in sequence. Only ACGTN allowed."
        )
    return codes


def codes_to_batch(seqs: list[np.ndarray], width: int | None = None) -> np.ndarray:
    """Stack variable-length code arrays into a right-padded [n, width] batch."""
    if width is None:
        width = max((len(s) for s in seqs), default=0)
    out = np.full((len(seqs), width), CODE_PAD, dtype=np.uint8)
    for i, s in enumerate(seqs):
        if len(s) > width:
            raise ValueError(f"sequence of length {len(s)} exceeds batch width {width}")
        out[i, : len(s)] = s
    return out


@functools.partial(jax.jit, static_argnames=("k",))
def canonical_kmers(codes: jax.Array, k: int):
    """Extract canonical k-mers from a fixed-width code batch.

    Args:
      codes: uint8 array [n_reads, width] with values 0..3 (bases),
        4 (N) or 5 (pad).
      k: k-mer length (static), 1..31.

    Returns:
      (kmers, valid): uint64 [n_reads, width-k+1] canonical k-mers and
      a bool mask of windows that contain only real bases. Invalid
      positions hold KMER_SENTINEL.
    """
    _check_k(k)
    n, width = codes.shape
    w = width - k + 1
    if w <= 0:
        return (
            jnp.full((n, 0), KMER_SENTINEL, dtype=jnp.uint64),
            jnp.zeros((n, 0), dtype=bool),
        )

    # Build the two frames in u32 PLANES (each element a 32-bit op).
    # Each window base lands in exactly one 32-bit plane of each
    # frame; the planes compare lexicographically for the canonical
    # min; only the final assembly touches u64 (one op per element).
    # Forward frame: base j at bit 2*(k-1-j) -> bases k-16..k-1 fill
    # the low plane, bases 0..k-17 the high plane. Reverse frame:
    # complemented base j at bit 2*j -> bases 0..15 low, 16..k-1 high.
    lo_split = max(k - 16, 0)  # first base index in the fwd low plane
    fwd_lo = jnp.zeros((n, w), dtype=jnp.uint32)
    fwd_hi = jnp.zeros((n, w), dtype=jnp.uint32)
    rev_lo = jnp.zeros((n, w), dtype=jnp.uint32)
    rev_hi = jnp.zeros((n, w), dtype=jnp.uint32)
    invalid = jnp.zeros((n, w), dtype=jnp.uint8)
    for j in range(k):
        c8 = jax.lax.dynamic_slice_in_dim(codes, j, w, axis=1)
        invalid = invalid | (c8 >> 2)  # codes 4/5 set a bit, 0..3 don't
        c = (c8 & 3).astype(jnp.uint32)
        if j >= lo_split:
            fwd_lo = fwd_lo | (c << jnp.uint32(2 * (k - 1 - j)))
        else:
            fwd_hi = fwd_hi | (c << jnp.uint32(2 * (k - 17 - j)))
        cc = c ^ jnp.uint32(3)
        if j < 16:
            rev_lo = rev_lo | (cc << jnp.uint32(2 * j))
        else:
            rev_hi = rev_hi | (cc << jnp.uint32(2 * (j - 16)))
    rev_less = (rev_hi < fwd_hi) | (
        (rev_hi == fwd_hi) & (rev_lo < fwd_lo)
    )
    hi = jnp.where(rev_less, rev_hi, fwd_hi)
    lo = jnp.where(rev_less, rev_lo, fwd_lo)
    valid = invalid == 0
    canon = (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(
        jnp.uint64
    )
    canon = jnp.where(valid, canon, jnp.uint64(KMER_SENTINEL))
    return canon, valid


# ---------------------------------------------------------------------------
# Pure-python reference + host-side helpers (primer preprocessing, output)
# ---------------------------------------------------------------------------

def kmers_from_ascii_ref(seq: str, k: int) -> list[int]:
    """Rolling-frame reference encoder; mirrors encoding.rs:332-371 exactly.

    Kept permanently for cross-check tests against ``canonical_kmers``.
    """
    _check_k(k)
    mask = (1 << (2 * k)) - 1
    kmers: list[int] = []
    frame = 0
    revframe = 0
    n_valid = 0
    for ch in seq:
        if ch == "N":
            frame = 0
            revframe = 0
            n_valid = 0
            continue
        try:
            base = "ACGT".index(ch)
        except ValueError:
            raise ValueError(
                f"Invalid character '{ch}' in sequence. Only ACGTN allowed."
            ) from None
        frame = ((frame << 2) | base) & ((1 << 64) - 1)
        revframe = (revframe >> 2) | ((3 - base) << (2 * (k - 1)))
        n_valid += 1
        if n_valid >= k:
            kmers.append(min(frame & mask, revframe & mask))
    return kmers


# byte LUT: reverse-complement of the 4 bases packed in one byte
# (matches the reference's REVCOMP_BYTE_LUT, encoding.rs:219-233)
_REVCOMP_BYTE_LUT = np.empty(256, dtype=np.uint8)
for _i in range(256):
    _b0, _b1, _b2, _b3 = _i & 3, (_i >> 2) & 3, (_i >> 4) & 3, (_i >> 6) & 3
    _REVCOMP_BYTE_LUT[_i] = (
        ((3 - _b0) << 6) | ((3 - _b1) << 4) | ((3 - _b2) << 2) | (3 - _b3)
    )


def revcomp_kmers_np_lut(kmers: np.ndarray, k: int) -> np.ndarray:
    """Byte-LUT reverse complement (the reference's REVCOMP_BYTE_LUT
    strategy, encoding.rs:219-233). Kept as the differential oracle for
    the bit-twiddling fast path below."""
    kmers = np.ascontiguousarray(kmers, dtype=np.uint64)
    b = kmers.view(np.uint8).reshape(-1, 8)
    if sys.byteorder != "little":  # pragma: no cover
        b = b[:, ::-1]
    rc_b = _REVCOMP_BYTE_LUT[b][:, ::-1]
    if sys.byteorder != "little":  # pragma: no cover
        rc_b = rc_b[:, ::-1]
    rc = np.ascontiguousarray(rc_b).view(np.uint64).reshape(kmers.shape)
    return rc >> np.uint64(64 - 2 * k)


_M2 = np.uint64(0x3333_3333_3333_3333)  # 2-bit group swap mask
_M4 = np.uint64(0x0F0F_0F0F_0F0F_0F0F)  # nibble swap mask


def revcomp_kmers_np(kmers: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement of packed k-mers (numpy, host).

    Pure u64 bit arithmetic — ~10x the byte-LUT version, which pays a
    gather per byte: complement is XOR with all-ones (3-b == b^3 for
    2-bit b), base reversal is two swap stages plus a byteswap, then a
    shift lands the k bases in the low 2k bits. The hot callers are the
    sPCR mirror build (tens of millions of keys) and per-wave candidate
    canonicalization.
    """
    x = ~np.ascontiguousarray(kmers, dtype=np.uint64)  # complement bases
    x = ((x & _M2) << np.uint64(2)) | ((x >> np.uint64(2)) & _M2)
    x = ((x & _M4) << np.uint64(4)) | ((x >> np.uint64(4)) & _M4)
    x = x.byteswap()  # reverse bytes -> full 2-bit-group reversal
    return x >> np.uint64(64 - 2 * k)


def revcomp_kmer(kmer: int, k: int) -> int:
    """Reverse complement of a 2-bit packed k-mer (host python int)."""
    out = 0
    for i in range(k):
        base = (kmer >> (2 * i)) & 3
        out = (out << 2) | (3 - base)
    return out & ((1 << (2 * k)) - 1)


def kmer_to_seq(kmer: int, k: int) -> str:
    return "".join(
        _CODE_TO_BASE[(kmer >> (2 * (k - 1 - i))) & 3] for i in range(k)
    )


def seq_to_kmer(seq: str) -> int:
    kmer = 0
    for ch in seq:
        kmer = (kmer << 2) | "ACGT".index(ch)
    return kmer


def kmer_last_base(kmer: int) -> str:
    return _CODE_TO_BASE[kmer & 3]


def count_valid_bases(seq: str) -> int:
    """Number of non-N bases (encoding.rs:374-376)."""
    return sum(1 for c in seq if c != "N")
