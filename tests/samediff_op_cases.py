"""Seeded cases of the op registry's names past the reference's line
1150, shared by ``tests/test_torch_samediff_ops_2b.py`` (the port against
the JAX package on the CPU) and ``chip_smoke.py`` (the card against the
CPU). numpy and torch only: no JAX here.

A case is (op, variant, build(Inputs) -> (inputs, attrs), grad): grad
None differentiates every float input, a tuple names the input positions,
() skips the gradient check.
"""

import zlib

import numpy as np
import torch

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


class Inputs:
    """Seeded numpy inputs for one case."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def f(self, *shape, lo=-1.0, hi=1.0):
        return self.rng.uniform(lo, hi, size=shape).astype(np.float32)

    def pos(self, *shape):
        return self.f(*shape, lo=0.5, hi=2.0)

    def ints(self, hi, *shape, lo=0):
        return self.rng.integers(lo, hi, size=shape).astype(np.int32)

    def spd(self, n=4):
        a = np.random.RandomState(0).randn(n, n).astype(np.float32)
        return a @ a.T + 4 * np.eye(n, dtype=np.float32)

    def lower(self, n=4):
        return np.tril(self.rng.uniform(size=(n, n)) + 1).astype(np.float32)


I32 = np.int32
F32 = np.float32
# compared by reconstruction: with full U and V the null-space columns
# and their signs are LAPACK's choice (jax and torch take other drivers)
BY_RECONSTRUCTION = {("svd", "full")}
LINALG = ("cholesky", "matrixInverse", "matrixDeterminant", "logdet",
          "solve", "triangularSolve", "svd", "qr", "lu", "lstsq")


# (op, variant, build(Inputs) -> (inputs, attrs), grad): grad None
# differentiates every float input, a tuple names the input positions,
# () skips the gradient check
def _cases():
    c = []

    def add(name, build, grad=None, variant=""):
        c.append((name, variant, build, grad))

    # linear algebra
    add("cholesky", lambda r: ([r.spd()], {}))
    add("cholesky", lambda r: ([-r.spd()], {}), grad=(),
        variant="not-positive-definite")
    for name in ("matrixInverse", "matrixDeterminant", "logdet"):
        add(name, lambda r: ([r.spd()], {}))
    add("trace", lambda r: ([r.f(4, 4)], {}))
    add("trace", lambda r: ([r.ints(9, 2, 3, 3)], {}), grad=(),
        variant="int")
    add("solve", lambda r: ([r.spd(), r.f(4, 2)], {}))
    add("solve", lambda r: ([r.f(4, 4) + 4 * np.eye(4, dtype=F32),
                             r.f(4, 2)], {"adjoint": True}),
        variant="adjoint")
    add("solve", lambda r: ([r.spd(), r.f(4)], {}), variant="vector")
    add("triangularSolve", lambda r: ([r.lower(), r.f(4, 2)],
                                      {"lower": True}))
    add("triangularSolve", lambda r: ([r.lower().T.copy(), r.f(4, 2)],
                                      {"lower": False}), variant="upper")
    add("triangularSolve", lambda r: ([r.lower(), r.f(4, 2)],
                                      {"lower": True, "adjoint": True}),
        variant="adjoint")
    add("triangularSolve", lambda r: ([r.lower(), r.f(4)], {}),
        variant="vector")
    add("svd", lambda r: ([r.f(5, 3)], {}))
    add("svd", lambda r: ([r.f(3, 5)], {"fullUV": True}), grad=(),
        variant="full")
    add("qr", lambda r: ([r.f(5, 3)], {}))
    add("qr", lambda r: ([r.f(5, 3)], {"fullMatrices": True}), grad=(),
        variant="full")
    add("lu", lambda r: ([r.f(4, 4)], {}))
    add("lstsq", lambda r: ([r.f(6, 3), r.f(6, 2)], {}))
    add("lstsq", lambda r: ([r.f(6, 3), r.f(6)], {}), variant="vector")
    add("matrixBandPart", lambda r: ([r.f(4, 5)], {"minLower": 1,
                                                   "maxUpper": 2}))
    add("matrixBandPart", lambda r: ([r.f(4, 5)], {"minLower": -1,
                                                   "maxUpper": 0}),
        variant="upper-off")
    add("triu", lambda r: ([r.f(4, 5)], {"diag": 1}))
    add("tril", lambda r: ([r.f(4, 5)], {"diag": -1}))
    add("diagPart", lambda r: ([r.f(2, 4, 5)], {}))
    # segment reductions
    seg_ids = np.asarray([0, 0, 1, 1, 1], I32)
    wild_ids = np.asarray([2, 0, 2, 5, -1, 0], I32)
    for kind in ("Sum", "Max", "Min", "Prod", "Mean"):
        # jax differentiates no product scatter (scatter_mul needs unique
        # indices), so the products are held by their values only
        prod = () if kind == "Prod" else None
        for pre in ("segment", "unsortedSegment"):
            name = pre + kind
            add(name, lambda r: ([r.f(5), seg_ids], {"numSegments": 2}),
                grad=prod)
            add(name, lambda r: ([r.f(6, 3), wild_ids],
                                 {"numSegments": 4}), variant="wild-empty",
                grad=(0,) if kind in ("Sum", "Mean") else ())
        add("segment" + kind, lambda r: ([r.f(5), seg_ids], {}),
            variant="inferred", grad=prod)
    add("segmentSum", lambda r: ([r.ints(9, 5), seg_ids], {}), grad=(),
        variant="int")
    add("segmentMax", lambda r: ([r.ints(9, 6), wild_ids],
                                 {"numSegments": 4}), grad=(),
        variant="int-empty")
    # top-k and friends (stable among equal values)
    ties = lambda r: r.ints(4, 3, 7).astype(F32)
    add("topK", lambda r: ([ties(r)], {"k": 3}))
    add("topK", lambda r: ([r.f(2, 5)], {"k": 1}), variant="k1")
    add("inTopK", lambda r: ([ties(r), r.ints(7, 3)], {"k": 2}), grad=())
    add("confusionMatrix", lambda r: ([r.ints(3, 8), r.ints(3, 8)],
                                      {"numClasses": 3}), grad=())
    add("confusionMatrix", lambda r: ([np.array([0, 1, 4, -1], I32),
                                       np.array([0, 1, 1, 2], I32)],
                                      {"numClasses": 3}), grad=(),
        variant="outside")
    add("bincount", lambda r: ([np.asarray([0, 1, 1, 3], I32)],
                               {"minLength": 5}), grad=())
    add("bincount", lambda r: ([np.asarray([0, 7], I32)], {"minLength": 3}),
        grad=(), variant="extends")
    add("bincount", lambda r: ([np.asarray([0, 7, 2, -3], I32)],
                               {"maxLength": 3}), grad=(),
        variant="maxLength")
    add("bincount", lambda r: ([r.ints(5, 9), r.f(9)], {"maxLength": 6}),
        grad=(1,), variant="weights")
    # image / spatial
    for method, hw in (("bilinear", (8, 4)), ("nearest", (3, 9)),
                       ("cubic", (7, 9)), ("bicubic", (4, 4)),
                       ("lanczos3", (4, 4)), ("lanczos5", (10, 3)),
                       ("area", (3, 2)), ("area", (2, 3))):
        add("imageResize",
            lambda r, m=method, hw=hw: ([r.f(1, 2, 6, 6)],
                                        {"height": hw[0], "width": hw[1],
                                         "method": m}),
            grad=() if method == "nearest" else None,
            variant=f"{method}-{hw[0]}x{hw[1]}")
    add("imageResize", lambda r: ([r.f(1, 2, 5, 6)],
                                  {"height": 3, "width": 4,
                                   "method": "area"}),
        variant="area-general")
    add("imageResize", lambda r: ([r.f(1, 2, 8, 8)],
                                  {"height": 3, "width": 5,
                                   "antialias": True}),
        variant="antialias")
    add("imageResize", lambda r: ([r.f(1, 2, 8, 8)],
                                  {"height": 3, "width": 5,
                                   "method": "lanczos3",
                                   "antialias": True}),
        variant="lanczos3-antialias")
    add("imageResize", lambda r: ([r.ints(9, 1, 1, 4, 4)],
                                  {"height": 2, "width": 2,
                                   "method": "area"}),
        grad=(), variant="int-area")
    add("imageResize", lambda r: ([r.ints(9, 1, 1, 4, 4)],
                                  {"height": 3, "width": 5,
                                   "method": "bilinear"}),
        grad=(), variant="int-bilinear")
    add("extractImagePatches", lambda r: ([r.f(1, 2, 5, 5)],
                                          {"kH": 2, "kW": 3, "sH": 2,
                                           "sW": 1}))
    add("extractImagePatches", lambda r: ([r.f(2, 3, 5, 4)],
                                          {"kH": 3, "kW": 2, "sH": 2,
                                           "sW": 2, "sameMode": True}),
        variant="same")
    add("spaceToDepth", lambda r: ([r.f(2, 4, 4, 4)], {"blockSize": 2}))
    add("depthToSpace", lambda r: ([r.f(2, 8, 2, 3)], {"blockSize": 2}))
    add("spaceToBatch", lambda r: ([r.f(2, 3, 4, 4)], {"blockSize": 2}))
    add("spaceToBatch", lambda r: ([r.f(1, 2, 4, 2)],
                                   {"blockSize": 2,
                                    "padding": ((1, 1), (0, 2))}),
        variant="padded")
    add("batchToSpace", lambda r: ([r.f(8, 3, 2, 2)], {"blockSize": 2}))
    add("batchToSpace", lambda r: ([r.f(8, 1, 3, 2)],
                                   {"blockSize": 2,
                                    "crop": ((0, 1), (1, 0))}),
        variant="cropped")
    # special functions
    add("erfc", lambda r: ([r.f(3, 4, lo=-2, hi=2)], {}))
    for name in ("lgamma", "digamma"):
        add(name, lambda r: ([r.f(3, 4, lo=0.1, hi=4)], {}))
        add(name, lambda r: ([np.array([0.0, -1.0, -2.0, -0.5, 1e-8, 1.0],
                                       F32)], {}), grad=(), variant="poles")
    add("igamma", lambda r: ([r.pos(3, 4), r.f(3, 4, lo=0.1, hi=3)], {}))
    add("igammac", lambda r: ([r.pos(3, 4), r.f(3, 4, lo=0.1, hi=3)], {}))
    add("igamma", lambda r: ([r.f(6, lo=2, hi=6), r.f(6, lo=5, hi=20)], {}),
        variant="large-x")
    add("igamma", lambda r: ([r.pos(3, 4), np.float32(1.5)], {}),
        variant="broadcast")
    for name in ("igamma", "igammac"):
        add(name, lambda r: ([np.array([0.0, 1.0, -1.0, 2.0], F32),
                              np.array([1.0, 0.0, 1.0, 0.0], F32)], {}),
            grad=(), variant="edges")
    add("betainc", lambda r: ([r.pos(3, 4), r.pos(3, 4),
                               r.f(3, 4, lo=0.05, hi=0.95)], {}),
        grad=(2,))
    add("betainc", lambda r: ([np.array([1.0, 1.0, 1.0, 2.0, -1.0], F32),
                               np.array([1.0, 1.0, 1.0, 3.0, 1.0], F32),
                               np.array([0.0, 1.0, 1.5, 0.5, 0.5], F32)],
                              {}), grad=(), variant="edges")
    add("betainc", lambda r: ([r.f(4, lo=20, hi=60), r.f(4, lo=20, hi=60),
                               r.f(4, lo=0.2, hi=0.8)], {}), grad=(2,),
        variant="large")
    add("atan2", lambda r: ([r.f(3, 4), r.f(3, 4)], {}))
    add("expm1", lambda r: ([r.f(3, 4)], {}))
    add("asinh", lambda r: ([r.f(3, 4, lo=-3, hi=3)], {}))
    add("acosh", lambda r: ([r.f(3, 4, lo=1.1, hi=4)], {}))
    add("atanh", lambda r: ([r.f(3, 4, lo=-0.9, hi=0.9)], {}))
    add("erfinv", lambda r: ([r.f(3, 4, lo=-0.95, hi=0.95)], {}))
    add("erfinv", lambda r: ([np.array([1.0, -1.0, 1.5, 0.0], F32)], {}),
        grad=(), variant="edges")
    # CTC
    add("ctcLoss", lambda r: ([np.array([[1, 2], [2, 2]], I32),
                               r.f(2, 4, 3, lo=-2, hi=2)], {}), grad=(1,))
    add("ctcLoss", lambda r: ([np.array([[1, 3, 0], [2, 0, 0]], I32),
                               r.f(2, 5, 4, lo=-2, hi=2),
                               np.array([2, 1], I32), np.array([5, 3], I32)],
                              {}), grad=(1,), variant="lengths")
    add("ctcLoss", lambda r: ([np.array([[0, 1]], I32),
                               r.f(1, 5, 3, lo=-2, hi=2)],
                              {"blankIndex": 2}), grad=(1,), variant="blank")
    add("ctcLoss", lambda r: ([np.array([[1, 1, 1]], I32),
                               r.f(1, 2, 3)], {}), grad=(),
        variant="impossible")
    # non-max suppression
    boxes = np.array([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60],
                      [0, 0, 5, 5]], F32)
    add("nonMaxSuppression", lambda r: ([boxes, np.array([0.9, 0.8, 0.7,
                                                          0.6], F32)],
                                        {"maxOutputSize": 4,
                                         "iouThreshold": 0.5}), grad=())
    add("nonMaxSuppression", lambda r: ([boxes, np.array([0.9, 0.1, 0.7,
                                                          0.6], F32)],
                                        {"maxOutputSize": 3,
                                         "iouThreshold": 0.2,
                                         "scoreThreshold": 0.5}), grad=(),
        variant="score-threshold")

    def random_boxes(r):
        b = r.f(16, 4, lo=0, hi=100)
        b[:, 2:] = b[:, :2] + 15
        return [b, r.f(16)]

    add("nonMaxSuppression", lambda r: (random_boxes(r),
                                        {"maxOutputSize": 6}), grad=(),
        variant="random")
    # shape and index utilities
    add("roll", lambda r: ([r.f(2, 3)], {"shift": 1, "dimensions": [1]}))
    add("roll", lambda r: ([r.f(2, 3)], {"shift": 2}), variant="flat")
    add("eye", lambda r: ([], {"rows": 3, "cols": 4}), grad=())
    add("eye", lambda r: ([], {"rows": 3, "dtype": "int32"}), grad=(),
        variant="int")
    add("repeat", lambda r: ([r.f(2, 3)], {"repeats": 2, "dimension": 1}))
    add("flip", lambda r: ([r.f(2, 3)], {"dimensions": [0]}))
    add("sort", lambda r: ([ties(r)], {}))
    add("sort", lambda r: ([ties(r)], {"descending": True, "dimension": 0}),
        variant="descending")
    add("argsort", lambda r: ([ties(r)], {}), grad=())
    add("argsort", lambda r: ([ties(r)], {"descending": True}), grad=(),
        variant="descending")
    add("fill", lambda r: ([], {"shape": [2, 3], "value": 7.0}), grad=())
    add("fill", lambda r: ([], {"shape": [2], "value": 3,
                                "dtype": "int32"}), grad=(), variant="int")
    add("tensorScatterUpdate", lambda r: ([r.f(3, 2),
                                           np.array([[0], [2]], I32),
                                           r.f(2, 2)], {}))
    add("tensorScatterUpdate", lambda r: ([r.f(3, 4),
                                           np.array([[0, 1], [2, 3], [-1, 0],
                                                     [5, 0]], I32),
                                           r.f(4)], {}), variant="nd-wild")
    add("uniqueWithCounts", lambda r: ([np.array([3, 1, 2, 2, 3, 3], I32)],
                                       {}), grad=())
    add("uniqueWithCounts", lambda r: ([np.array([3.0, 1.0, 3.0], F32)],
                                       {"size": 2}), grad=(), variant="cut")
    add("uniqueWithCounts", lambda r: ([np.array([3.0, 1.0, 3.0], F32)],
                                       {"size": 5}), grad=(), variant="pad")
    add("cross", lambda r: ([r.f(4, 3), r.f(4, 3)], {}))
    add("rint", lambda r: ([np.array([1.4, 2.5, 3.6, -0.5, -1.5, 0.5], F32)],
                           {}), grad=())
    add("reverseSequence", lambda r: ([r.f(2, 6), np.array([3, 5], I32)],
                                      {}), grad=(0,))
    add("reverseSequence", lambda r: ([r.f(4, 2, 3), np.array([2, 4], I32)],
                                      {"seqAxis": 0, "batchAxis": 1}),
        grad=(0,), variant="seq-first")
    add("histogramFixedWidth", lambda r: ([np.array([0.0, 0.1, 0.9, 1.0, 0.5],
                                                    F32)],
                                          {"range_lo": 0.0, "range_hi": 1.0,
                                           "nbins": 2}), grad=())
    add("histogramFixedWidth", lambda r: ([r.f(40, lo=-2, hi=3)],
                                          {"range_lo": -1.0, "range_hi": 2.0,
                                           "nbins": 7}), grad=(),
        variant="outside")
    add("weightedCrossEntropyWithLogits",
        lambda r: ([r.ints(2, 8).astype(F32), r.f(8, lo=-3, hi=3)],
                   {"posWeight": 3.0}))
    add("meanPairwiseSquaredError", lambda r: ([r.f(2, 3), r.f(2, 3)], {}))
    add("clipByGlobalNorm", lambda r: ([np.full((2, 2), 3.0, F32) + r.f(2, 2),
                                        np.full((2,), 4.0, F32)],
                                       {"clipNorm": 1.0}))
    add("clipByGlobalNorm", lambda r: ([r.f(2, 2), r.f(3)],
                                       {"clipNorm": 100.0}),
        variant="unclipped")
    add("matrixSetDiag", lambda r: ([r.f(3, 3), r.f(3)], {}))
    add("matrixSetDiag", lambda r: ([r.f(2, 3, 4), r.f(2, 4)], {}),
        variant="batched")
    for name in ("scatterMax", "scatterMin", "scatterMul", "scatterSub"):
        prod = () if name == "scatterMul" else None
        add(name, lambda r: ([r.f(4, 2), np.array([0, 2], I32), r.f(2, 2)],
                             {}), grad=prod)
        add(name, lambda r: ([r.f(4, 2), np.array([-1, 7, 1], I32),
                              r.f(3, 2)], {}), variant="wild", grad=prod)
    add("scatterNd", lambda r: ([np.array([[0], [2], [0]], I32), r.f(3),
                                 np.array([4], I32)], {}), grad=(1,))
    add("scatterNd", lambda r: ([np.array([[0, 1], [1, 0]], I32), r.f(2, 3)],
                                {"shape": (2, 2, 3)}), grad=(1,),
        variant="slices")
    add("dynamicStitch", lambda r: ([(np.array([0, 2], I32),
                                      np.array([1, 3], I32)),
                                     (r.f(2, 3), r.f(2, 3))], {}), grad=())
    add("mirrorPad", lambda r: ([r.f(3, 4)], {"paddings": [[1, 1], [2, 2]]}))
    add("mirrorPad", lambda r: ([r.f(3, 4)], {"paddings": [[0, 2], [1, 0]],
                                              "mode": "SYMMETRIC"}),
        variant="symmetric")
    add("rot90", lambda r: ([r.f(2, 3, 4)], {}))
    add("rot90", lambda r: ([r.f(2, 3, 4)], {"k": 3, "axes": (1, 2)}),
        variant="k3")
    add("sconv2d", lambda r: ([r.f(1, 3, 6, 6), r.f(3, 3, 3, 2),
                               r.f(1, 1, 6, 4)], {}))
    add("sconv2d", lambda r: ([r.f(1, 2, 7, 7), r.f(2, 2, 2, 1),
                               r.f(1, 1, 2, 3)],
                              {"strides": (2, 2), "sameMode": False}),
        variant="strided")
    add("localResponseNormalization",
        lambda r: ([r.f(1, 6, 2, 2)], {"depth": 2, "bias": 1.0, "alpha": 0.5,
                                       "beta": 0.75}))
    add("dilation2d", lambda r: ([r.f(1, 2, 5, 5), r.f(2, 3, 3)], {}))
    add("dilation2d", lambda r: ([r.f(1, 2, 6, 5), r.f(2, 2, 3)],
                                 {"sH": 2, "sW": 2, "sameMode": False}),
        variant="valid-strided")
    add("dilation2d", lambda r: ([np.full((1, 1, 4, 4), -10.0, F32),
                                  np.zeros((1, 3, 3), F32)], {}), grad=(),
        variant="negative-border")
    add("adjustContrast", lambda r: ([r.f(1, 3, 4, 4)], {"factor": 2.0}))
    add("adjustContrast", lambda r: ([r.f(4, 4)], {"factor": 0.5}),
        variant="2d")
    img = lambda r: r.f(5, 5, 3, lo=0.05, hi=0.95)
    add("rgbToHsv", lambda r: ([img(r)], {}))
    add("hsvToRgb", lambda r: ([img(r)], {}))
    add("adjustHue", lambda r: ([img(r)], {"delta": 0.1}))
    add("adjustSaturation", lambda r: ([img(r)], {"factor": 0.5}))
    add("sparseSoftmaxCrossEntropyGrad", lambda r: ([r.f(4, 7),
                                                     r.ints(7, 4)], {}),
        grad=(0,))
    add("adjustContrastV2", lambda r: ([r.f(1, 4, 4, 3)], {"factor": 1.5}))
    # the noise layers at inference are the identity
    for name in ("alphaDropout", "gaussianDropout", "gaussianNoise"):
        add(name, lambda r: ([r.f(4, 4)], {}), grad=(), variant="inference")
    return c


CASES = _cases()
IDS = [f"{n}-{v}" if v else n for n, v, _, _ in CASES]


def build(name, variant, build_fn):
    """A case's inputs and attributes, from its own seed."""
    return build_fn(Inputs(zlib.crc32(f"2b-{name}-{variant}".encode())))


def to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def close(got, want, tol, what):
    """got to tol of want's largest finite element; NaN and infinities
    where want has them."""
    got, want = to_numpy(got), to_numpy(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == np.bool_ or got.dtype == np.bool_:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    g, w = got.astype(np.float64), want.astype(np.float64)
    fin = np.isfinite(w)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=what)
    np.testing.assert_array_equal(g[np.isinf(w)], w[np.isinf(w)],
                                  err_msg=what)
    scale = float(np.abs(w[fin]).max()) if fin.any() else 1.0
    np.testing.assert_allclose(g[fin], w[fin], rtol=0,
                               atol=tol * max(scale, 1e-30), err_msg=what)


def reconstructs(name, got, x, tol):
    """The card's factorization against the input it factors (cuSOLVER's
    signs may differ from LAPACK's)."""
    x = x.double()
    if name == "svd":
        s, u, v = (t.double() for t in got)
        k = s.shape[-1]
        rec = (u[..., :k] * s[..., None, :]) @ v[..., :k].mT
        ref = torch.linalg.svdvals(x)
        close(s.cpu(), ref, tol, "singular values")
        for m in (u, v):
            close((m.mT @ m).cpu(), torch.eye(m.shape[-1], dtype=x.dtype),
                   tol, "orthonormal")
    elif name == "qr":
        q, r = (t.double() for t in got)
        rec = q @ r
        close((q.mT @ q).cpu(), torch.eye(q.shape[-1], dtype=x.dtype), tol,
               "q orthonormal")
    else:   # lu: the packed factors and pivots reproduce P A
        lu, piv = got
        lu = lu.double()
        n = lu.shape[-1]
        lower = torch.tril(lu, -1) + torch.eye(n, dtype=lu.dtype,
                                               device=lu.device)
        rec = lower @ torch.triu(lu)
        perm = list(range(n))
        for i, p in enumerate(piv.cpu().tolist()):
            perm[i], perm[p] = perm[p], perm[i]
        x = x[perm]
    close(rec.cpu(), x.cpu(), tol, f"{name} reconstruction")
