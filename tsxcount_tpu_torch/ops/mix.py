"""Cheap ARX mixing of k-mer keys: the mix-prefix extended key, and the
lane-mix bijection (the lane-mix kernel, csrc/lane_mix.cu).

A copy of the JAX package's ops/mix.py.  Two uses of the same
multiply-xorshift arithmetic:

  * `mix_cols`: a 64-bit mixing hash (mix_lo, mix_hi) of a key, a function
    of the key only.  With `mix_prefix` the store holds EXTENDED keys
    [lane_0 .. lane_{L-1}, mix_lo, mix_hi] at `make_ext_spec(spec)`, whose
    top lane is full, so the invalid flag is an operand of its own and the
    dedupe sorts (flag, mix_hi, mix_lo) with the raw lanes as payload.
    Equal extended keys are equal raw keys; exports drop the two columns
    (`strip_mix`), queries recompute them (`extend_keys_host`).  The JAX
    package computes the columns in XLA, outside any Pallas kernel; here
    they are plain PyTorch elementwise ops on the `_TorchU32` arithmetic.
  * `LaneMixBijection`, an invertible map of the 2k-bit key space built
    as an unbalanced XOR-Feistel over the uint32 lanes.  With `hash_first`
("mix", automatic from 8 lanes, k >= 113) the store holds each key's image,
the dedupe sorts only a >= 64-bit prefix of it (ops/count.py), queries map
through the mix on the host and the export maps back on the device.

Three half-rounds over lo = lanes [0, L/2) and hi = lanes [L/2, L):
    hi ^= F(lo, salt 1);  lo ^= F(hi, salt 2);  hi ^= F(lo, salt 3)
each undone by replaying them in reverse.  F folds its inputs into two
uint32 accumulators (multiply, xorshift, multiply-add) and draws each output
from them through a murmur3 finalizer.  The top lane's F output is masked
to the key's top bits, so the map permutes exactly the 2k-bit keys.  A
single-lane key (k <= 16) takes multiply/xorshift rounds modulo 2^2k.

The JAX package has no Pallas kernel here: XLA fuses the ~30 operations a
lane into one elementwise pass.  Eager PyTorch would launch several hundred
kernels a batch, so the card runs one CUDA kernel (one thread a position,
every lane read and written once); `lane_mix_plain` is its twin on the CPU.
torch has no uint32 arithmetic worth the name (ops/lanes.py), so the plain
version computes in int64 on values masked to 32 bits, with every product
split so that no intermediate passes 2^49.
"""

from __future__ import annotations

import numpy as np
import torch

from tsxcount_tpu_torch import _build
from tsxcount_tpu_torch.config import WORD_BITS, KmerSpec
from tsxcount_tpu_torch.ops.lanes import MASK32, i32, u32
from tsxcount_tpu_torch.utils.profiling import span

MIX_LANES = 2  # extended key = raw lanes + (mix_lo, mix_hi)

# distinct odd multipliers per input lane (splitmix64 / murmur3 family
# constants, truncated to 32 bits), as in the JAX package
_LANE_MULT_A = (
    0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
    0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09,
    0xCC9E2D51, 0x1B873593, 0xE6546B65, 0x38495AB5,
    0x7FEB352D, 0x846CA68B, 0x9E3779B9, 0xC2B2AE35,
    0x94D049BB, 0xBF58476D,
)
_LANE_MULT_B = (
    0x2545F491, 0x6C62272F, 0x52DCE729, 0x38EA70B3,
    0x9FB21C65, 0x1D8048FB, 0xA2AA033B, 0x62992FC1,
    0x30BF3847, 0xAD93481B, 0x4BAE4A77, 0x85D068E9,
    0x8EE0D535, 0x16A85F0F, 0x5851F42D, 0x4C957F2D,
    0xF767814F, 0x2127599B,
)


class _NumpyU32:
    """uint32 arithmetic on numpy uint32 arrays (wraps natively)."""

    @staticmethod
    def mul(x, c: int):
        return x * np.uint32(c)

    @staticmethod
    def add(x, c: int):
        return x + np.uint32(c)

    @staticmethod
    def shr(x, s: int):
        return x >> np.uint32(s)


class _TorchU32:
    """uint32 arithmetic on int64 tensors holding values in [0, 2^32)."""

    @staticmethod
    def mul(x, c: int):
        lo, hi = c & 0xFFFF, c >> 16
        return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32

    @staticmethod
    def add(x, c: int):
        return (x + c) & MASK32

    @staticmethod
    def shr(x, s: int):
        return x >> s


# --- the mix-prefix extended key ---------------------------------------------

def _fmix(h, m1: int, m2: int, xp):
    """murmur3 fmix32 avalanche with multipliers m1, m2."""
    h = h ^ xp.shr(h, 16)
    h = xp.mul(h, m1)
    h = h ^ xp.shr(h, 13)
    h = xp.mul(h, m2)
    return h ^ xp.shr(h, 16)


def _mix(cols, xp) -> tuple:
    """(mix_lo, mix_hi) of per-lane uint32 columns (lsb lane first)."""
    n = len(cols)
    if n > len(_LANE_MULT_A):
        raise ValueError(f"mix_cols supports up to {len(_LANE_MULT_A)} lanes")
    h1 = 0x9E3779B9 ^ ((n * 0x85EBCA6B) & MASK32)
    h2 = 0xC2B2AE35 ^ ((n * 0x27D4EB2F) & MASK32)
    for i, c in enumerate(cols):
        ka = xp.mul(c, _LANE_MULT_A[i])
        ka = ka ^ xp.shr(ka, 15)
        kb = xp.mul(c, _LANE_MULT_B[i])
        kb = kb ^ xp.shr(kb, 17)
        h1 = xp.add(xp.mul(h1 ^ ka, 5), 0xE6546B64)
        h2 = xp.add(xp.mul(h2 ^ kb, 5), 0x38495AB5)
    # cross-coupled final avalanche: every lane reaches both words
    h1 = h1 ^ xp.mul(h2, 0x9E3779B1)
    lo = _fmix(h1, 0x85EBCA6B, 0xC2B2AE35, xp)
    hi = _fmix(h2 ^ lo, 0xCC9E2D51, 0x1B873593, xp)
    return lo, hi


def mix_cols(cols) -> tuple[torch.Tensor, torch.Tensor]:
    """64-bit mixing hash of per-lane int32 columns (lsb lane first):
    (mix_lo, mix_hi) int32 columns, bit for bit the JAX package's."""
    lo, hi = _mix([u32(c) for c in cols], _TorchU32)
    return i32(lo), i32(hi)


def mix_cols_host(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """mix_cols of stacked (N, lanes) uint32 keys on the host (numpy)."""
    cols = [keys[:, j].astype(np.uint32) for j in range(keys.shape[1])]
    lo, hi = _mix(cols, _NumpyU32)
    return lo.astype(np.uint32), hi.astype(np.uint32)


def extend_cols(cols) -> list[torch.Tensor]:
    """Raw lane columns -> extended key columns [lanes..., mix_lo, mix_hi]."""
    return list(cols) + list(mix_cols(cols))


def extend_keys(keys: torch.Tensor) -> torch.Tensor:
    """(..., lanes) raw int32 keys -> (..., lanes + 2) extended keys."""
    lo, hi = mix_cols([keys[..., j] for j in range(keys.shape[-1])])
    return torch.cat([keys, lo[..., None], hi[..., None]], dim=-1)


def extend_keys_host(keys: np.ndarray) -> np.ndarray:
    """(N, lanes) raw uint32 keys -> (N, lanes + 2) extended keys."""
    lo, hi = mix_cols_host(keys)
    return np.concatenate([keys, lo[:, None], hi[:, None]],
                          axis=1).astype(np.uint32)


def strip_mix(keys_ext):
    """(..., lanes + 2) extended keys -> (..., lanes) raw keys."""
    return keys_ext[..., :-MIX_LANES]


def make_ext_spec(spec: KmerSpec) -> KmerSpec:
    """The KmerSpec of the extended key: 32 * (lanes + 2) bits, so its top
    lane (mix_hi) is full, the invalid flag stands alone as the msb
    operand, and the uniform-prefix sort compares (flag, mix_hi, mix_lo).
    Raises above k = 224, where lanes + 2 exceeds 16 lanes."""
    ext_lanes = spec.lanes + MIX_LANES
    if ext_lanes * 16 > 256:
        raise ValueError(
            f"mix-prefix extended keys support k <= 224 (k={spec.k} needs "
            f"{ext_lanes} lanes > the 256-base spec ceiling); use the "
            "full-comparator sort for wider keys"
        )
    return KmerSpec(ext_lanes * WORD_BITS // 2)


# --- the lane-mix bijection --------------------------------------------------


def _fmix_g(h, xp):
    h = h ^ xp.shr(h, 16)
    h = xp.mul(h, 0x85EBCA6B)
    h = h ^ xp.shr(h, 13)
    h = xp.mul(h, 0xC2B2AE35)
    return h ^ xp.shr(h, 16)


def _f_outputs(cols, n_out: int, salt: int, xp) -> list:
    """n_out well-mixed uint32 streams from `cols`: two shared
    accumulators, then one finalizer per output."""
    h1 = 0x9E3779B9 ^ ((salt * 0x7FEB352D) & MASK32)
    h2 = 0xC2B2AE35 ^ ((salt * 0x846CA68B) & MASK32)
    n_mult = len(_LANE_MULT_A)
    for i, c in enumerate(cols):
        ka = xp.mul(c, _LANE_MULT_A[(i + salt) % n_mult])
        ka = ka ^ xp.shr(ka, 15)
        kb = xp.mul(c, _LANE_MULT_B[(i + salt) % n_mult])
        kb = kb ^ xp.shr(kb, 17)
        h1 = xp.add(xp.mul(ka ^ h1, 5), 0xE6546B64)
        h2 = xp.add(xp.mul(kb ^ h2, 5), 0x38495AB5)
    outs = []
    for j in range(n_out):
        v = h1 ^ xp.mul(h2, _LANE_MULT_A[(j + 7 * salt) % n_mult])
        outs.append(_fmix_g(xp.add(v, _LANE_MULT_B[(j + 5 * salt) % n_mult]),
                            xp))
    return outs


def _unxorshift(y, s: int, bits: int, xp):
    """Invert x ^= x >> s on a `bits`-bit value."""
    x = y
    for _ in range(max(0, -(-bits // s) - 1)):
        x = y ^ xp.shr(x, s)
    return x


class LaneMixBijection:
    """Invertible ARX lane mix over (N, lanes) uint32 keys, bit for bit the
    JAX package's.  Device keys are int32 bit patterns (lanes lsb first);
    host keys numpy uint32."""

    def __init__(self, spec: KmerSpec):
        self.spec = spec
        b = spec.top_lane_bits
        # single-lane parameters: odd multipliers invertible mod 2^b
        self._odd1 = 0x9E3779B1 & ((1 << b) - 1) | 1
        self._odd2 = 0x85EBCA77 & ((1 << b) - 1) | 1
        self._inv1 = pow(self._odd1, -1, 1 << b)
        self._inv2 = pow(self._odd2, -1, 1 << b)
        self._shift = max(1, b // 2)
        self._unshift_steps = max(0, -(-b // self._shift) - 1)

    # -- the arithmetic, for numpy uint32 or int64 tensors ------------------

    def _apply1(self, x, xp, inverse: bool):
        """Single lane: multiply/xorshift permutation mod 2^bits."""
        b = self.spec.top_lane_bits
        mask = self.spec.top_lane_mask
        s = self._shift
        if not inverse:
            x = xp.mul(x, self._odd1) & mask
            x = x ^ xp.shr(x, s)
            x = xp.mul(x, self._odd2) & mask
            return x ^ xp.shr(x, s)
        x = _unxorshift(x, s, b, xp)
        x = xp.mul(x, self._inv2) & mask
        x = _unxorshift(x, s, b, xp)
        return xp.mul(x, self._inv1) & mask

    def _apply_cols(self, cols: list, xp, inverse: bool) -> list:
        lanes = self.spec.lanes
        if lanes == 1:
            return [self._apply1(cols[0], xp, inverse)]
        h = lanes // 2
        lo, hi = list(cols[:h]), list(cols[h:])
        top_mask = self.spec.top_lane_mask

        def xor_hi(salt):
            outs = _f_outputs(lo, len(hi), salt, xp)
            outs[-1] = outs[-1] & top_mask
            for j, o in enumerate(outs):
                hi[j] = hi[j] ^ o

        def xor_lo(salt):
            for j, o in enumerate(_f_outputs(hi, len(lo), salt, xp)):
                lo[j] = lo[j] ^ o

        for step in ((3, 2, 1) if inverse else (1, 2, 3)):
            (xor_lo if step == 2 else xor_hi)(step)
        return lo + hi

    # -- device (tensors) ---------------------------------------------------

    def apply_cols(self, cols) -> list[torch.Tensor]:
        """Per-lane int32 columns (lsb first) -> image columns; the dedupe
        hot path (no stacked [P, lanes] tensor)."""
        return lane_mix(cols, self, inverse=False)

    def apply(self, keys: torch.Tensor) -> torch.Tensor:
        """(..., lanes) int32 keys -> their images."""
        return self._stacked(keys, inverse=False)

    def inv_apply(self, hashes: torch.Tensor) -> torch.Tensor:
        return self._stacked(hashes, inverse=True)

    def _stacked(self, keys: torch.Tensor, inverse: bool) -> torch.Tensor:
        shape = keys.shape
        flat = keys.reshape(-1, shape[-1])
        cols = [flat[:, j].contiguous() for j in range(shape[-1])]
        out = lane_mix(cols, self, inverse)
        return torch.stack(out, dim=-1).reshape(shape)

    # -- host (numpy) -------------------------------------------------------

    def _host(self, keys: np.ndarray, inverse: bool) -> np.ndarray:
        cols = [keys[..., j].astype(np.uint32) for j in range(keys.shape[-1])]
        out = self._apply_cols(cols, _NumpyU32, inverse)
        return np.stack(out, axis=-1).astype(np.uint32)

    def apply_host(self, keys: np.ndarray) -> np.ndarray:
        return self._host(keys, False)

    def inv_apply_host(self, hashes: np.ndarray) -> np.ndarray:
        return self._host(hashes, True)


def lane_mix_plain(cols, mix: LaneMixBijection, inverse: bool = False
                   ) -> list[torch.Tensor]:
    """Plain PyTorch version: int32 lane columns -> image (or preimage)
    columns, in int64 arithmetic masked to 32 bits."""
    out = mix._apply_cols([u32(c) for c in cols], _TorchU32, inverse)
    return [i32(c) for c in out]


def lane_mix(cols, mix: LaneMixBijection, inverse: bool = False
             ) -> list[torch.Tensor]:
    """The lane mix of `mix.spec.lanes` equal-length int32 columns (lsb
    lane first).  CPU tensors take the plain version; CUDA tensors launch
    the kernel on the current stream (no synchronisation).  Either is the
    span `mix`, forward (the routing step) and inverse (the export)."""
    cols = tuple(cols)
    spec = mix.spec
    if len(cols) != spec.lanes:
        raise ValueError(f"lane_mix: {len(cols)} columns for {spec.lanes} "
                         f"lanes")
    n = cols[0].shape[0]
    dev = _build.check_columns("lane_mix", cols, (torch.int32,), n)
    with span("mix"):
        if dev.type == "cpu":
            return lane_mix_plain(cols, mix, inverse)
        _build.require_cuda("lane_mix", dev)
        out = [torch.empty_like(c) for c in cols]
        if n == 0:
            return out
        rc = _build.kernels().tsx_lane_mix(
            _build.ptr_array(cols), _build.ptr_array(out), spec.lanes, n,
            int(inverse), spec.top_lane_mask, mix._odd1, mix._odd2,
            mix._inv1, mix._inv2, mix._shift, mix._unshift_steps,
            _build.stream(),
        )
        _build.check(rc, "lane_mix")
        # the routing step's columns are overlapping views of one stream
        _build.count_launch("lane_mix", positions=n, lanes=spec.lanes,
                            input_bytes=lambda: _build.distinct_bytes(cols))
        return out
