"""A ResNet bottleneck in one hand-written CUDA kernel, in the six variants
of the repo's Pallas probes.

Counterparts of the Pallas kernels of ``tools/probe_fused_block.py``
(``fused_block`` -> ``_fused_kernel``, ``fused_block2d`` ->
``_fused_kernel2d``) and ``tools/probe_fused_parts.py`` (``k_matmuls``,
``k_pad``, ``k_mask``, ``k_folded``), all in ``csrc/fused_bottleneck.cu``
(one kernel on ``wgmma`` fed by TMA, templated on F's width class, the
variant a launch argument; the design and its bounds are in the file's
header). ``plan`` computes its launch plan as the source does, for the
CPU tests; ``source_plan`` asks the compiled source. Each computes

    conv1x1 -> epilogue -> 3x3 as 9 row-shifted products -> epilogue
    -> conv1x1 -> epilogue (+ residual)

on flat NHWC rows ``r = (img*h + y)*h + x`` in bfloat16 with float32
sums. Weights: w1 [C, F], w2 [9, F, F] (tap ky*3 + kx), w3 [F, C] bf16;
affines s*, b* float32 [1, F] or [1, C].

- ``fused_block`` / ``fused_block2d``: the exact identity block (SAME
  3x3 conv, f32 affine + ReLU epilogues, + x, ReLU); x [n, h, h, C].
  ``g`` (images per TPU grid step) does not change the result.
- ``block_matmuls``: the three products only; the 3x3 step multiplies
  the same y1 row by each of the 9 taps (no shift), no epilogues.
- ``block_pad``: the 9 taps read y1 at row r + (ky-1)h + (kx-1) within
  the group of ``g`` images (zero outside the group's g h h rows, real
  data across an image's border inside it), no masks, no epilogues.
- ``block_mask``: the exact SAME 3x3 conv (edge masks), no epilogues.
- ``block_folded``: ``k_folded``: bf16 bias epilogues, x-edge masks by
  the destination row and none in y, so at g > 1 an image's top and bottom
  rows read the neighbouring image's rows, as the reference does;
  (y3 + b3) + x as two bf16 roundings.

The ``block_*`` functions take x flat [n h h, C] and ``h`` and ``g`` by
keyword. All six raise ValueError when n % g != 0 (the reference's grid
would leave rows unwritten). Each takes its plain version (``*_reference``,
float32 upcast, rounding to bf16 where the reference's
``.astype(jnp.bfloat16)`` stands, affines as a multiply then an add) only
for tensors on the CPU; on a CUDA tensor it launches its kernel or raises.
Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from deeplearning4j_tpu_torch.kernels import build
from deeplearning4j_tpu_torch.kernels.lstm import _count
from deeplearning4j_tpu_torch.kernels.probe_matmul import aligned

BF16 = torch.bfloat16
# csrc/fused_bottleneck.cu's variant numbers
VARIANTS = ("fused_block", "fused_block2d", "block_matmuls", "block_pad",
            "block_mask", "block_folded")
PLAN_FIELDS = ("band_rows", "bands", "halo", "y1_rows", "smem_bytes",
               "stages", "threads", "f_class", "items", "grid",
               "affines_in_smem")
# csrc/fused_bottleneck.cu's launch constants
THREADS = 2 * 128      # two warpgroups; thread 0 also loads
TILE_ROWS = 128        # rows of a tile: 64 a warpgroup
BK = 64                # k of a ring stage
MAX_BAND = 1024
SMEM_LIMIT = 232448    # a block's opt-in shared memory on an H100

# ---------------------------------------------------------------------------
# plain versions (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------


def _mm(a, b):
    """a b in float32 from bf16 (or float32) operands."""
    return a.float() @ b.float()


def _relu(v):
    return torch.clamp_min(v, 0.0)


def _affine(y, s, b):
    return y * s.reshape(1, -1) + b.reshape(1, -1)


def _rb(v):
    """Round float32 to bf16 and back (a ``.astype(jnp.bfloat16)``)."""
    return v.to(BF16).float()


def _group_taps(y1, w2, h, g, *, shift=True, mask=None):
    """sum over taps of shift(y1) w2[tap] in float32, y1 [M, F] in groups
    of g images: a tap reads row r + (ky-1)h + (kx-1) of its group, zero
    outside it (``shift=False``: row r). ``mask(ky, kx, yy, xx, sl, w,
    h)`` gives a tap's masked product, from the destination rows' image
    row yy and column xx."""
    f = y1.shape[1]
    rows = g * h * h
    pad = h + 1
    yg = nnf.pad(y1.float().reshape(-1, rows, f), (0, 0, pad, pad))
    r = torch.arange(rows, device=y1.device)
    yy = ((r % (h * h)) // h)[None, :, None]
    xx = (r % h)[None, :, None]
    acc = torch.zeros(yg.shape[0], rows, f, dtype=torch.float32,
                      device=y1.device)
    for ky in range(3):
        for kx in range(3):
            off = (ky - 1) * h + (kx - 1) if shift else 0
            sl = yg[:, pad + off:pad + off + rows]
            tap = ky * 3 + kx
            if mask is None:
                acc = acc + _mm(sl, w2[tap])
            else:
                acc = acc + mask(ky, kx, yy, xx, sl, w2[tap], h)
    return acc.reshape(-1, f)


def _exact_mask(ky, kx, yy, xx, sl, w, h):
    """A tap's product, zero where (y+ky-1, x+kx-1) leaves the image (the
    reference multiplies the dot by the mask)."""
    ok = ((yy + ky - 1 >= 0) & (yy + ky - 1 < h) &
          (xx + kx - 1 >= 0) & (xx + kx - 1 < h))
    return _mm(sl, w) * ok.float()


def _x_mask(ky, kx, yy, xx, sl, w, h):
    """``k_folded``'s masks: the slice's kx = 0 rows zeroed where x = 0,
    its kx = 2 rows where x = h - 1 (by the destination row)."""
    if kx == 0:
        sl = sl * (xx > 0).float()
    elif kx == 2:
        sl = sl * (xx < h - 1).float()
    return _mm(sl, w)


def _flat(x):
    return x.reshape(-1, x.shape[-1])


def _block2d(x2, p, h, g):
    """The exact block on flat rows, ``_fused_kernel2d``'s formulation."""
    y1 = _relu(_affine(_mm(x2, p["w1"]), p["s1"], p["b1"])).to(BF16)
    acc = _group_taps(y1, p["w2"], h, g, mask=_exact_mask)
    y2 = _relu(_affine(acc, p["s2"], p["b2"])).to(BF16)
    y3 = _affine(_mm(y2, p["w3"]), p["s3"], p["b3"])
    return _relu(y3 + x2.float()).to(BF16)


def fused_block_reference(x, params, g):
    """The plain version of ``fused_block``, as ``_fused_kernel`` computes
    it: each image zero-padded by one pixel, the 9 taps as slices of the
    padded image."""
    n, h, _, c = _check_block("fused_block", x, params, g)
    f = params["w1"].shape[1]
    y1 = _mm(_flat(x), params["w1"])
    y1 = _relu(_affine(y1, params["s1"], params["b1"])).to(BF16)
    padded = nnf.pad(y1.float().reshape(n, h, h, f), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(n * h * h, f, dtype=torch.float32, device=x.device)
    for ky in range(3):
        for kx in range(3):
            sl = padded[:, ky:ky + h, kx:kx + h, :].reshape(-1, f)
            acc = acc + _mm(sl, params["w2"][ky * 3 + kx])
    y2 = _relu(_affine(acc, params["s2"], params["b2"])).to(BF16)
    y3 = _affine(_mm(y2, params["w3"]), params["s3"], params["b3"])
    out = _relu(y3 + _flat(x).float()).to(BF16)
    return out.reshape(n, h, h, c)


def fused_block2d_reference(x, params, g):
    """The plain version of ``fused_block2d``: flat rows, the 9 taps as
    row shifts masked at the image's edges."""
    n, h, _, c = _check_block("fused_block2d", x, params, g)
    return _block2d(_flat(x), params, h, g).reshape(n, h, h, c)


def block_matmuls_reference(x, w1, w2, w3, *, h, g):
    """The plain version of ``block_matmuls`` (``k_matmuls``)."""
    _check_flat("block_matmuls", x, w1, w2, w3, h, g)
    y1 = _mm(x, w1).to(BF16)
    acc = _group_taps(y1, w2, h, g, shift=False)
    return _mm(acc.to(BF16), w3).to(BF16)


def block_pad_reference(x, w1, w2, w3, *, h, g):
    """The plain version of ``block_pad`` (``k_pad``)."""
    _check_flat("block_pad", x, w1, w2, w3, h, g)
    y1 = _mm(x, w1).to(BF16)
    acc = _group_taps(y1, w2, h, g)
    return _mm(acc.to(BF16), w3).to(BF16)


def block_mask_reference(x, w1, w2, w3, *, h, g):
    """The plain version of ``block_mask`` (``k_mask``)."""
    _check_flat("block_mask", x, w1, w2, w3, h, g)
    y1 = _mm(x, w1).to(BF16)
    acc = _group_taps(y1, w2, h, g, mask=_exact_mask)
    return _mm(acc.to(BF16), w3).to(BF16)


def block_folded_reference(x, w1, b1, w2, b2, w3, b3, *, h, g):
    """The plain version of ``block_folded`` (``k_folded``): bf16 bias
    adds and ReLUs, x-edge masks, (y3 + b3) + x rounded twice."""
    _check_flat("block_folded", x, w1, w2, w3, h, g, b1=b1, b2=b2, b3=b3)
    y1 = _relu(_rb(_rb(_mm(x, w1)) + _rb(b1.reshape(1, -1)))).to(BF16)
    acc = _group_taps(y1, w2, h, g, mask=_x_mask)
    y2 = _relu(_rb(_rb(acc) + _rb(b2.reshape(1, -1)))).to(BF16)
    y3 = _rb(_mm(y2, w3))
    out = _rb(_rb(y3 + _rb(b3.reshape(1, -1))) + x.float())
    return _relu(out).to(BF16)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _check_weights(what, c, f, w1, w2, w3, device):
    for name, w, shape in (("w1", w1, (c, f)), ("w2", w2, (9, f, f)),
                           ("w3", w3, (f, c))):
        if tuple(w.shape) != shape or w.dtype != BF16:
            raise ValueError(f"{what}: {name} must be bfloat16 {list(shape)}"
                             f", got {w.dtype} {list(w.shape)}")
        if w.device != device:
            raise ValueError(f"{what}: {name} lies on {w.device}, x on "
                             f"{device}")


def _check_affine(what, name, a, width, device):
    if a.numel() != width or a.dtype != torch.float32 or \
            a.device != device:
        raise ValueError(f"{what}: {name} must be float32 [1, {width}] on "
                         f"{device}, got {a.dtype} {list(a.shape)} on "
                         f"{a.device}")


def _check_g(what, n, g):
    if not isinstance(g, int) or g < 1 or n % g:
        raise ValueError(f"{what}: g={g} must divide the batch n={n} (the "
                         f"reference's grid of n // g steps would leave "
                         f"rows unwritten)")


def _check_device(what, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def _check_block(what, x, params, g):
    """(n, h, h, C) of a block's x, after checking x, params and g."""
    if x.dim() != 4 or x.shape[1] != x.shape[2] or min(x.shape) < 1 \
            or x.dtype != BF16:
        raise ValueError(f"{what}: x must be bfloat16 [n, h, h, C], got "
                         f"{x.dtype} {list(x.shape)}")
    _check_device(what, x)
    n, h, _, c = x.shape
    f = params["w1"].shape[-1]
    _check_weights(what, c, f, params["w1"], params["w2"], params["w3"],
                   x.device)
    for name, width in (("s1", f), ("b1", f), ("s2", f), ("b2", f),
                        ("s3", c), ("b3", c)):
        _check_affine(what, name, params[name], width, x.device)
    _check_g(what, n, g)
    return n, h, h, c


def _check_flat(what, x, w1, w2, w3, h, g, **biases):
    """n of a flat variant's x [n h h, C], after checking its inputs."""
    if x.dim() != 2 or x.dtype != BF16 or min(x.shape) < 1:
        raise ValueError(f"{what}: x must be bfloat16 [n*h*h, C], got "
                         f"{x.dtype} {list(x.shape)}")
    _check_device(what, x)
    if not isinstance(h, int) or h < 1 or x.shape[0] % (h * h):
        raise ValueError(f"{what}: {x.shape[0]} rows are not n images of "
                         f"{h}x{h}")
    c, f = x.shape[1], w1.shape[-1]
    _check_weights(what, c, f, w1, w2, w3, x.device)
    for name, b in biases.items():
        _check_affine(what, name, b, c if name == "b3" else f, x.device)
    n = x.shape[0] // (h * h)
    _check_g(what, n, g)
    return n


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _cuda_shapes(what, c, f):
    if c % 16 or f % 16:
        raise ValueError(f"{what}: C={c} and F={f} must be multiples of 16")


class Refused(ValueError):
    """A shape the kernel does not take, with the source's return code:
    -1 C or F not a multiple of 16, -2 n not a multiple of g, -3 an empty
    dimension, -4 no band's y1 fits in shared memory, -5 no such
    variant."""

    def __init__(self, name, n, h, c, f, g, code):
        super().__init__(f"{name}: the kernel refuses n={n}, h={h}, C={c}, "
                         f"F={f}, g={g} (code {code})")
        self.code = code


def f_class(f):
    """F's width class: the register arrays' size the kernel is built
    for (1024 for any F past 512, which it takes 256 columns at a
    time)."""
    return next((w for w in (64, 128, 256, 512) if f <= w), 1024)


def stage_bytes(fm):
    """Bytes of a ring stage for width class ``fm``: conv1's 128 rows of x
    beside its w1 boxes (128 columns at most), or conv2's or conv3's
    weight boxes (conv2 128 columns of F at a time, 64 from 512; conv3
    128 columns of C, 64 from 512)."""
    n1 = min(fm, 128)
    n2, n3 = (64, 64) if fm >= 512 else (min(fm, 128), 128)
    return max(TILE_ROWS * BK * 2 + n1 * BK * 2, max(n2, n3) * BK * 2)


def affine_floats(name, c, f):
    """The affines variant ``name`` keeps in shared memory: s1, b1, s2,
    b2 and s3, b3 for the exact blocks, b1, b2, b3 for block_folded."""
    if name in ("fused_block", "fused_block2d"):
        return 4 * f + 2 * c
    return 2 * f + c if name == "block_folded" else 0


def smem_bytes(name, stages, fm, y1_rows, c, f, affines=True):
    """Shared bytes: 1 KB to align the ring, the ring, y1 (row stride
    F + 8), two mbarriers a stage, the producer's 128-byte cursor and,
    with ``affines``, the variant's affines in float32."""
    return (1024 + stages * stage_bytes(fm) + y1_rows * (f + 8) * 2 +
            2 * stages * 8 + 128 +
            (4 * affine_floats(name, c, f) if affines else 0))


def plan(name, n, h, c, f, g, sms):
    """The kernel's launch plan for variant ``name`` at this shape on a card
    of ``sms`` SMs, as ``csrc/fused_bottleneck.cu`` computes it
    (``fused_bottleneck_plan``), for the CPU tests: bands of R rows of a
    group of g h h rows, R the widest multiple of 64 (at most 1024) whose
    y1 (R + 2 halo rows) fits beside the ring, else the widest band below
    64 rows that fits, or the whole group where it is narrower; a ring of
    4 stages where that leaves the band 128 rows (or the whole group),
    else 3 where it leaves 64, else 2; the affines in shared memory
    unless only their absence lets a band fit; the last band of a group
    takes what is left; work items are groups x bands, band-major (item
    i is band i // groups of group i % groups), walked by a persistent
    grid of min(items, sms) blocks (block i takes items i, i + grid, ...).
    A dict of ``PLAN_FIELDS``; raises ``Refused`` where the source
    refuses."""
    if name not in VARIANTS:
        raise Refused(name, n, h, c, f, g, -5)
    if min(n, h, c, f, g) < 1:
        raise Refused(name, n, h, c, f, g, -3)
    if c % 16 or f % 16:
        raise Refused(name, n, h, c, f, g, -1)
    if n % g:
        raise Refused(name, n, h, c, f, g, -2)
    fm = f_class(f)
    halo = 0 if name == "block_matmuls" else h + 1
    rows = g * h * h

    def widest(stages, affines):
        fits = [r for r in (*range(1, 64), *range(64, MAX_BAND + 1, 64))
                if smem_bytes(name, stages, fm, r + 2 * halo, c, f,
                              affines) <= SMEM_LIMIT]
        return fits[-1] if fits else 0

    for affines in (True, False):
        stages = (4 if widest(4, affines) >= min(rows, 128) else
                  3 if widest(3, affines) >= min(rows, 64) else 2)
        if widest(stages, affines):
            break
    else:
        raise Refused(name, n, h, c, f, g, -4)
    band = min(rows, widest(stages, affines))
    bands = -(-rows // band)
    y1_rows = band + 2 * halo
    items = n // g * bands
    return dict(band_rows=band, bands=bands, halo=halo, y1_rows=y1_rows,
                smem_bytes=smem_bytes(name, stages, fm, y1_rows, c, f,
                                      affines),
                stages=stages, threads=THREADS, f_class=fm, items=items,
                grid=min(items, sms), affines_in_smem=int(affines))


def source_plan(name, n, h, c, f, g, device=None):
    """The kernel's launch plan for variant ``name`` at this shape on the
    current card, asked of ``csrc/fused_bottleneck.cu`` (nothing
    launched): a dict of ``PLAN_FIELDS``. Raises ``Refused`` for a shape
    the kernel refuses."""
    out = torch.zeros(len(PLAN_FIELDS), dtype=torch.int32)
    device = torch.device("cuda") if device is None else device
    rc = build.query("fused_bottleneck", "fused_bottleneck_plan",
                     "fused_bottleneck plan",
                     [VARIANTS.index(name), n, h, c, f, g, out], device)
    if rc != 0:
        raise Refused(name, n, h, c, f, g, rc)
    return dict(zip(PLAN_FIELDS, (int(v) for v in out)))


def _launch(fn, x2, n, h, g, w1, w2, w3, s1=None, b1=None, s2=None,
            b2=None, s3=None, b3=None):
    """Launch variant ``fn.__name__`` on flat x2 [n h h, C]."""
    what = fn.__name__
    c, f = x2.shape[1], w1.shape[1]
    _cuda_shapes(what, c, f)
    x2, w1, w2, w3 = (aligned(t) for t in (x2, w1, w2, w3))
    s1, b1, s2, b2, s3, b3 = (None if t is None else t.contiguous()
                              for t in (s1, b1, s2, b2, s3, b3))
    out = torch.empty_like(x2)
    build.call("fused_bottleneck", "fused_bottleneck_run", what,
               [VARIANTS.index(what), x2, w1, s1, b1, w2, s2, b2, w3, s3,
                b3, out, n, h, c, f, g], x2.device)
    _count(fn)
    return out


def _affines(params):
    return {k: params[k] for k in ("s1", "b1", "s2", "b2", "s3", "b3")}


def fused_block(x, params, g):
    """The exact identity bottleneck on x [n, h, h, C] bf16; ``params`` as
    the reference's ``make_params`` (``utils/convert.py``
    ``bottleneck_params_from_numpy``)."""
    n, h, _, c = _check_block("fused_block", x, params, g)
    if x.device.type == "cpu":
        return fused_block_reference(x, params, g)
    out = _launch(fused_block, _flat(x), n, h, g, params["w1"],
                  params["w2"], params["w3"], **_affines(params))
    return out.reshape(n, h, h, c)


def fused_block2d(x, params, g):
    """``fused_block`` in the reference's 2D formulation (the same
    function)."""
    n, h, _, c = _check_block("fused_block2d", x, params, g)
    if x.device.type == "cpu":
        return fused_block2d_reference(x, params, g)
    out = _launch(fused_block2d, _flat(x), n, h, g, params["w1"],
                  params["w2"], params["w3"], **_affines(params))
    return out.reshape(n, h, h, c)


def block_matmuls(x, w1, w2, w3, *, h, g):
    """``k_matmuls``: x [n h h, C] -> [n h h, C], products only."""
    n = _check_flat("block_matmuls", x, w1, w2, w3, h, g)
    if x.device.type == "cpu":
        return block_matmuls_reference(x, w1, w2, w3, h=h, g=g)
    return _launch(block_matmuls, x, n, h, g, w1, w2, w3)


def block_pad(x, w1, w2, w3, *, h, g):
    """``k_pad``: shifted taps within each group of g images, no masks."""
    n = _check_flat("block_pad", x, w1, w2, w3, h, g)
    if x.device.type == "cpu":
        return block_pad_reference(x, w1, w2, w3, h=h, g=g)
    return _launch(block_pad, x, n, h, g, w1, w2, w3)


def block_mask(x, w1, w2, w3, *, h, g):
    """``k_mask``: the exact 3x3 conv between the products, no
    epilogues."""
    n = _check_flat("block_mask", x, w1, w2, w3, h, g)
    if x.device.type == "cpu":
        return block_mask_reference(x, w1, w2, w3, h=h, g=g)
    return _launch(block_mask, x, n, h, g, w1, w2, w3)


def block_folded(x, w1, b1, w2, b2, w3, b3, *, h, g):
    """``k_folded``: bf16 bias epilogues, x-edge masks only."""
    n = _check_flat("block_folded", x, w1, w2, w3, h, g, b1=b1, b2=b2,
                    b3=b3)
    if x.device.type == "cpu":
        return block_folded_reference(x, w1, b1, w2, b2, w3, b3, h=h, g=g)
    return _launch(block_folded, x, n, h, g, w1, w2, w3, b1=b1, b2=b2,
                   b3=b3)


for _fn in (fused_block, fused_block2d, block_matmuls, block_pad,
            block_mask, block_folded):
    _fn.launches = 0
