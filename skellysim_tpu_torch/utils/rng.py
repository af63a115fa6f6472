"""Counter-based RNG with dump/restore, the analogue of the reference's trng4
`yarn2` engines.

Counterpart of `skellysim_tpu.utils.rng`: two named streams (``shared``,
``distributed``), each ``seed:stream_id:counter``, dumped into every
trajectory frame's ``rng_state`` and restored from it. Every draw folds the
stream's counter into its base key and spends exactly one counter whatever
its size, so a restored stream continues the JAX package's stream.

The draws reproduce `jax.random` bit for bit on the host, in numpy
``uint32`` / ``uint64`` arithmetic (no torch RNG): the threefry2x32 hash,
``PRNGKey`` / ``fold_in`` / ``split``, and the partitionable ``random_bits``
(jax's default layout, ``jax_threefry_partitionable``), under the x64
settings the JAX package's CLI runs with (float64 uniforms, int64 randint).
`poisson_int` follows jax's float32 samplers (Knuth below 10, Hormann's
transformed rejection above) and evaluates their ``log`` / ``log1p`` /
``lgamma`` as XLA's CPU backend does (its Cephes-based float32 polynomials,
with the multiply-adds it fuses), so the counts match jax's, not only their
law. `normal` is sqrt(2) erfinv(u) with XLA's float64 erfinv and log1p (libm's
log where XLA calls it).
"""

from __future__ import annotations

import math
import struct

import numpy as np

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32 = np.float32
_U32 = np.uint32


# ------------------------------------------------------------------ threefry

def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x0, x1) under
    ``key`` (two uint32 words): jax's `threefry2x32_p`."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0 = np.array(x0, dtype=_U32, ndmin=1) + ks[0]
    x1 = np.array(x1, dtype=_U32, ndmin=1) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = (x1 << _U32(r)) | (x1 >> _U32(32 - r))
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3]
        x1 += _U32(i + 1)
    return x0, x1


def seed_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with x64 on: the seed's high and low
    32-bit words."""
    s = int(seed) % (1 << 64)
    return np.array([(s >> 32) & _M32, s & _M32], dtype=_U32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of the pair (0, data)."""
    y0, y1 = threefry2x32(key, [0], [int(data) & _M32])
    return np.array([y0[0], y1[0]], dtype=_U32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` under the partitionable scheme: key i
    is the hash of the pair (0, i). Returns [num, 2] uint32."""
    y0, y1 = threefry2x32(key, np.zeros(num, _U32), np.arange(num, dtype=_U32))
    return np.stack([y0, y1], axis=1)


def random_bits(key, bit_width: int, n: int) -> np.ndarray:
    """``n`` words of jax's partitionable `random_bits` (flat index i hashed
    as the pair (i >> 32, i & 0xFFFFFFFF)): 32 bits are the two hash words
    xor'ed, 64 bits the first word high and the second low."""
    i = np.arange(max(n, 1), dtype=np.uint64)[:n]
    b1, b2 = threefry2x32(key, (i >> np.uint64(32)).astype(_U32),
                          (i & np.uint64(_M32)).astype(_U32))
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def _unit_floats(bits, dtype) -> np.ndarray:
    """jax's `_uniform` mantissa trick: [1, 2) from the top mantissa bits,
    minus one."""
    if dtype == np.float64:
        f = ((bits >> np.uint64(12)) | np.uint64(0x3FF0000000000000)).view(
            np.float64)
        return f - 1.0
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(_F32)
    return f - _F32(1)


def uniform(key, n: int, dtype=np.float64, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, (n,), dtype, minval, maxval)``."""
    dtype = np.dtype(dtype).type
    lo, hi = dtype(minval), dtype(maxval)
    f = _unit_floats(random_bits(key, 32 if dtype == _F32 else 64, n), dtype)
    return np.maximum(lo, f * (hi - lo) + lo)


def randint(key, n: int, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, (n,), minval, maxval)`` at int64: two 64-bit
    draws from a split key, combined modulo the span in uint64."""
    k1, k2 = split(key)
    hi_bits, lo_bits = random_bits(k1, 64, n), random_bits(k2, 64, n)
    lo_v, hi_v = int(minval), int(maxval)
    span = np.uint64(1 if hi_v <= lo_v else (hi_v - lo_v) % (1 << 64))
    mult = np.uint64((1 << 32) % int(span))
    mult = np.uint64((int(mult) * int(mult)) % int(span))
    off = ((hi_bits % span) * mult + (lo_bits % span)) % span
    return np.int64(lo_v) + off.astype(np.int64)


# ------------------------------------------------- XLA's float32 functions

def _f32(hex64: str):
    """A float32 constant written as the 64-bit hex of its double value."""
    return _F32(struct.unpack(">d", bytes.fromhex(hex64))[0])


def _fma32(a, b, c):
    """float32 fused multiply-add (the contractions XLA's CPU backend makes):
    the product is exact in float64, the sum rounded once there."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


_LOG_P = [_f32(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000")]
_LOG1P_DEN = [_F32(1)] + [_f32(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000")]
_LOG1P_NUM = [_f32(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000")]
_FLT_MIN = _F32(1.17549435e-38)


def _log32(x):
    """XLA's CPU float32 log (the Cephes polynomial); denormals flush to
    zero."""
    x = np.asarray(x, _F32)
    bits = np.maximum(x, _FLT_MIN).view(np.int32)
    e = (((bits >> 23) & 0xFF) - 127).astype(_F32) + _F32(1)
    m = ((bits & np.int32(-0x7F800001)) | np.int32(0x3F000000)).view(_F32)
    small = m < _f32("3FE6A09E60000000")
    m = (m - _F32(1)) + np.where(small, m, _F32(0))
    e = e - np.where(small, _F32(1), _F32(0))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma32(m, p[0], p[1])
    y1 = _fma32(m, p[3], p[4])
    y2 = _fma32(m, p[6], p[7])
    y = _fma32(y, m, p[2])
    y1 = _fma32(y1, m, p[5])
    y2 = _fma32(y2, m, p[8])
    y = _fma32(y, x3, y1)
    y = _fma32(y, x3, y2)
    y = _fma32(y, x3, e * _f32("BF2BD01060000000"))
    m = _fma32(_F32(-0.5), x2, m)
    out = _fma32(e, _f32("3FE6300000000000"), m + y)
    out = np.where(x < _FLT_MIN, _F32(-np.inf), out)
    out = np.where(x < 0, _F32(np.nan), out)
    return np.where(np.isposinf(x), _F32(np.inf), out).astype(_F32)


def _log1p32(x):
    """XLA's CPU float32 log1p: a rational approximation below
    sqrt(2) - 1 in magnitude, log(1 + x) above."""
    x = np.asarray(x, _F32)
    x2 = x * x
    den = np.zeros_like(x)
    for c in _LOG1P_DEN:
        den = _fma32(den, x, c)
    num = np.zeros_like(x)
    for c in _LOG1P_NUM:
        num = _fma32(num, x, c)
    small = x + _fma32(x2, _F32(-0.5), (x * x2) * (num / den))
    with np.errstate(invalid="ignore", divide="ignore"):
        large = _log32(x + _F32(1))
    return np.where(np.abs(x) < _f32("3FDA8279A0000000"), small, large)


_LANCZOS = [_F32(c) for c in (
    676.520368121885098567009190444019, -1259.13921672240287047156078755283,
    771.3234287776530788486528258894, -176.61502916214059906584551354,
    12.507343278686904814458936853, -0.13857109526572011689554707,
    9.984369578019570859563e-6, 1.50563273514931155834e-7)]


def _lgamma32(v):
    """XLA's float32 lgamma (Lanczos, g = 7) for v >= 0.5, the only range
    the Poisson sampler's accept test reads."""
    z = np.asarray(v, _F32) - _F32(1)
    t = z + _F32(7.5)
    log_t = _log1p32(z * _F32(1 / 7.5)) + _F32(math.log(7.5))
    head = _fma32((z + _F32(0.5)) - t / log_t, log_t,
                  _F32((math.log(2) + math.log(math.pi)) / 2))
    with np.errstate(divide="ignore", invalid="ignore"):
        s = _LANCZOS[0] / (z + _F32(1)) + _F32(1)
        for i, c in enumerate(_LANCZOS[1:], start=2):
            s = s + c / (z + _F32(i))
        return head + _log32(s)


# -------------------------------------------------------------- samplers

def _poisson_knuth(key, lam, n):
    """jax's `_poisson_knuth` (lam < 10): count draws until the float32 sum
    of log-uniforms falls to -lam."""
    neg = -lam
    k = np.zeros(n, np.int64)
    log_prod = np.zeros(n, _F32)
    rng = key
    while (log_prod > neg).any():
        rng, sub = split(rng)
        k = np.where(log_prod > neg, k + 1, k)
        log_prod = log_prod + _log32(uniform(sub, n, _F32))
    return k - 1


def _poisson_rejection(key, lam, n):
    """jax's `_poisson_rejection` (lam >= 10): Hormann's transformed
    rejection in float32, with XLA's fused multiply-adds."""
    log_lam = _log32(lam)
    b = _fma32(_F32(2.53), np.sqrt(lam), _F32(0.931))
    a = _fma32(_F32(0.02483), b, _F32(-0.059))
    inv_alpha = _F32(1.1239) + _F32(1.1328) / (b - _F32(3.4))
    v_r = _F32(0.9277) - _F32(3.6224) / (b - _F32(2))
    two_a = _F32(2) * a
    k_out = np.full(n, -1, np.int64)
    accepted = np.zeros(n, bool)
    while not accepted.all():
        key, sub0, sub1 = split(key, 3)
        u = uniform(sub0, n, _F32) - _F32(0.5)
        v = uniform(sub1, n, _F32)
        us = _F32(0.5) - np.abs(u)
        k = np.floor(_fma32(two_a / us + b, u, lam) + _F32(0.43))
        with np.errstate(divide="ignore", invalid="ignore"):
            s = _log32(v * inv_alpha / (a / (us * us) + b))
            t = _fma32(k, log_lam, -lam) - _lgamma32(k + _F32(1))
        accept1 = (us >= _F32(0.07)) & (v <= v_r)
        reject = (k < 0) | ((us < _F32(0.013)) & (v > us))
        accept = accept1 | (~reject & (s <= t))
        k_out = np.where(accept, k.astype(np.int64), k_out)
        accepted |= accept
    return k_out


def poisson(key, lam: float, n: int) -> np.ndarray:
    """``jax.random.poisson(key, lam, (n,))`` at int64: lam is cast to
    float32; Knuth below 10, rejection from 10; lam = 0 gives zeros."""
    lam = _F32(lam)
    if lam == 0:
        return np.zeros(n, np.int64)
    if lam < 10 or np.isnan(lam):
        return _poisson_knuth(key, lam, n)
    return _poisson_rejection(key, lam, n)


def _two_prod(a, b):
    """a * b as an unevaluated sum (Dekker's product, Veltkamp's split)."""
    p = a * b
    c = 134217729.0 * a
    ah = c - (c - a)
    c = 134217729.0 * b
    bh = c - (c - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma64(a, b, c):
    """float64 a * b + c with one rounding (in all but ties of ties): the
    multiply-adds XLA's CPU backend fuses."""
    a, b, c = np.broadcast_arrays(np.asarray(a, np.float64),
                                  np.asarray(b, np.float64),
                                  np.asarray(c, np.float64))
    p, e = _two_prod(a, b)
    s = p + c
    bb = s - p
    return s + (e + ((p - (s - bb)) + (c - bb)))


def _f64(words: str):
    return [struct.unpack(">d", bytes.fromhex(h))[0] for h in words.split()]


_LOG1P64_DEN = [1.0] + _f64(
    "402E20359E903E37 4054C30B52213498 406BB86590FCFB56 407351945DC908A5 "
    "406B0DB13E48E066 404E0F304466448E")
_LOG1P64_NUM = _f64(
    "3F07BC0962B395CA 3FDFE818A0FE1A83 401A509F46F4FA53 403DE9738B8CB9C9 "
    "404E798EB86C3351 404C8E7597479A10 40340A202D99830A")
_LOG1P64_SMALL = _f64("3FDA827999FCEF32")[0]
_libm_log = np.frompyfunc(math.log, 1, 1)


def _log1p64(x):
    """XLA's CPU float64 log1p: the float32 path's rational approximation
    at float64 below sqrt(2) - 1 in magnitude, libm's log(1 + x) above."""
    x = np.asarray(x, np.float64)
    x2 = x * x
    den = np.zeros_like(x)
    for c in _LOG1P64_DEN:
        den = _fma64(den, x, c)
    num = np.zeros_like(x)
    for c in _LOG1P64_NUM:
        num = _fma64(num, x, c)
    out = x + _fma64(x2, -0.5, (x * x2) * (num / den))
    large = np.abs(x) >= _LOG1P64_SMALL
    with np.errstate(divide="ignore"):
        out[large] = np.where(x[large] + 1 > 0, _libm_log(
            np.maximum(x[large] + 1, np.finfo(np.float64).tiny)).astype(
                np.float64), -np.inf)
    return out


#: XLA's float64 erfinv (Giles' polynomials in w = -log1p(-x^2): w < 6.25,
#: w < 16, beyond)
_ERFINV_COEFFS = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221))


def erfinv(x):
    """float64 inverse error function (XLA's polynomials)."""
    x = np.asarray(x, np.float64)
    w = -_log1p64(-(x * x))
    out = np.empty_like(x)
    for sel, shift, coeffs in ((w < 6.25, None, _ERFINV_COEFFS[0]),
                               ((w >= 6.25) & (w < 16), 3.25,
                                _ERFINV_COEFFS[1]),
                               (w >= 16, 5.0, _ERFINV_COEFFS[2])):
        ww = w[sel] - 3.125 if shift is None else np.sqrt(w[sel]) - shift
        p = np.full_like(ww, coeffs[0])
        for c in coeffs[1:]:
            p = _fma64(p, ww, c)
        out[sel] = p * x[sel]
    return np.where(np.abs(x) == 1, x * np.inf, out)


def normal(key, n: int) -> np.ndarray:
    """``jax.random.normal(key, (n,), float64)``: sqrt(2) erfinv of a
    uniform on (-1, 1)."""
    lo = np.nextafter(-1.0, 0.0)
    return np.sqrt(2.0) * erfinv(uniform(key, n, np.float64, lo, 1.0))


# ---------------------------------------------------------------- streams

def _shape(size):
    return () if size is None else ((size,) if np.isscalar(size)
                                    else tuple(size))


class Stream:
    """One counter-based draw stream. Every draw folds the counter into the
    base key, so (seed, stream_id, counter) fully determines the future
    sequence."""

    def __init__(self, seed: int, stream_id: int, counter: int = 0):
        self.seed = int(seed)
        self.stream_id = int(stream_id)
        self.counter = int(counter)
        self._base = fold_in(seed_key(self.seed), self.stream_id)

    def _next_key(self):
        k = fold_in(self._base, self.counter)
        self.counter += 1
        return k

    def _draw(self, sampler, size, *args, cast=float):
        shape = _shape(size)
        out = sampler(self._next_key(), *args, math.prod(shape))
        return cast(out[0]) if size is None else out.reshape(shape)

    def uniform(self, low=0.0, high=1.0, size=None):
        return self._draw(lambda k, n: uniform(k, n, np.float64, low, high),
                          size)

    def uniform_int(self, low: int, high: int, size=None):
        """Integer in [low, high) (trng `uniform_int_dist` semantics)."""
        return self._draw(lambda k, n: randint(k, n, low, high), size,
                          cast=int)

    def normal(self, mu=0.0, sigma=1.0, size=None):
        out = self._draw(normal, size)
        return mu + sigma * out

    def poisson_int(self, lam: float, size=None):
        return self._draw(lambda k, n: poisson(k, lam, n), size, cast=int)

    def dump(self) -> str:
        return f"{self.seed}:{self.stream_id}:{self.counter}"

    @staticmethod
    def load(s: str) -> "Stream":
        seed, stream_id, counter = (int(v) for v in s.split(":"))
        return Stream(seed, stream_id, counter)


class SimRNG:
    """The two-stream RNG bundle."""

    def __init__(self, seed: int = 1):
        self.shared = Stream(seed, 0)
        self.distributed = Stream(seed, 1)

    def member(self, i: int) -> "SimRNG":
        """Per-member bundle for ensemble replicas: stream ids (2i+2, 2i+3)
        of the same seeds (see the JAX package)."""
        if i < 0:
            raise ValueError(f"member index must be >= 0, got {i}")
        rng = SimRNG.__new__(SimRNG)
        rng.shared = Stream(self.shared.seed, 2 * i + 2)
        rng.distributed = Stream(self.distributed.seed, 2 * i + 3)
        return rng

    def dump_state(self):
        """Trajectory ``rng_state`` payload: [[name, state], ...]."""
        return [["shared", self.shared.dump()],
                ["distributed", self.distributed.dump()]]

    @staticmethod
    def from_state(state) -> "SimRNG":
        rng = SimRNG()
        names = {name: s for name, s in state}
        if "shared" in names:
            rng.shared = Stream.load(names["shared"])
        if "distributed" in names:
            rng.distributed = Stream.load(names["distributed"])
        return rng
