"""The port's probe kernels (``kernels/probe_matmul.py``,
``kernels/bottleneck.py``) and probe entry points against the JAX package's
tool probes.

The plain versions (what the wrappers run for CPU tensors, and what the
CUDA kernels are held against on the card by chip_smoke.py) against the
Pallas kernel bodies of ``tools/``, run in TPU interpret mode on the CPU:

- row 8: ``kern`` of ``tools/probe_matmul.py`` (nested in
  ``bench_pallas``);
- row 9: ``fused_block`` and ``fused_block2d`` of
  ``tools/probe_fused_block.py``, and its ``xla_block``;
- row 10: ``k_matmuls``, ``k_pad``, ``k_mask`` and ``k_folded`` of
  ``tools/probe_fused_parts.py``, launched by its own ``build`` and
  ``build2``.

``tools/probe_matmul.py`` and ``tools/probe_fused_parts.py`` run their
benchmark at import, so their kernel bodies (and the launch helpers) are
taken out of the source with ``ast`` and run in a namespace that sets the
module constants (H, C, F, N, G, M) small. Inputs come from numpy seeds,
with non-zero affines and biases so that every epilogue counts.

Tolerance, per output: max |d| <= 1e-2 of its largest element (about one
bf16 ulp) and at most 1e-3 of its elements differing: the two sides sum in
float32 in other orders, which flips a bf16 rounding now and then.

The ``cuda`` cases hold the kernels against their plain versions on the
card; they build their parameters from numpy (``_numpy_params``), since
the card's machine has no JAX.
"""

import ast
import functools
import importlib
import io
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from deeplearning4j_tpu_torch.kernels import bottleneck, probe_matmul
from deeplearning4j_tpu_torch.tools import probe_fused_block as port_block
from deeplearning4j_tpu_torch.tools.probe_matmul import SHAPES as MATMULS
from deeplearning4j_tpu_torch.utils.convert import (
    bottleneck_params_from_numpy)
from tools import probe_fused_block as jblock

ROOT = Path(__file__).resolve().parent.parent
MAX_TOL = 1e-2
DIFF_FRAC = 1e-3
N = 4
PORT_PROBES = ("probe_matmul", "probe_fused_block", "probe_fused_parts")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast, and leaves the cores
    to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want):
    """The file's tolerance, on bf16 (or float) arrays of one shape."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    d = np.abs(got - want)
    assert d.max() <= MAX_TOL * np.abs(want).max(), d.max()
    assert (d > 0).mean() <= DIFF_FRAC, (d > 0).mean()


def _np(t):
    return t.float().numpy()


def _bf(a):
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _source_nodes(path, names):
    """The top-level (or nested) function definitions and assignments of
    ``names`` in the source at ``path``, in source order."""
    tree = ast.parse((ROOT / path).read_text())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in names:
            found.append(node)
        elif isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) in names for t in node.targets):
            found.append(node)
    return sorted(found, key=lambda n: n.lineno)


def _exec_nodes(path, names, **constants):
    ns = dict(jax=jax, jnp=jnp, lax=lax, pl=pl, pltpu=pltpu,
              functools=functools, **constants)
    module = ast.Module(body=_source_nodes(path, names), type_ignores=[])
    exec(compile(module, str(ROOT / path), "exec"), ns)
    return ns


# ---------------------------------------------------------------------------
# row 8: tools/probe_matmul.py kern
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,bm", [(64, 32, 16, 16), (112, 64, 48, 56)])
def test_matmul_plain_version_matches_pallas_kern(m, k, n, bm):
    kern = _exec_nodes("tools/probe_matmul.py", {"kern"})["kern"]
    rng = np.random.default_rng([m, k, n])
    a = jnp.asarray(rng.normal(size=(m, k)) * 0.1, jnp.bfloat16)
    b = jnp.asarray(rng.normal(size=(k, n)) * 0.1, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = pl.pallas_call(
            kern, grid=(m // bm,),
            in_specs=[pl.BlockSpec((bm, k), lambda i: (i, 0)),
                      pl.BlockSpec((k, n), lambda i: (0, 0))],
            out_specs=pl.BlockSpec((bm, n), lambda i: (i, 0)),
            out_shape=jax.ShapeDtypeStruct((m, n), jnp.bfloat16))(a, b)
    ta, tb = _bf(a), _bf(b)
    _close(_np(probe_matmul.matmul_bf16_reference(ta, tb)), want)
    got = probe_matmul.matmul_bf16(ta, tb)       # the CPU route
    assert got.dtype == torch.bfloat16
    _close(_np(got), want)


def test_matmul_refuses_what_is_not_a_product():
    a = torch.zeros(4, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not make"):
        probe_matmul.matmul_bf16(a, torch.zeros(8, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bfloat16"):
        probe_matmul.matmul_bf16(a.float(), torch.zeros(16, 16))


SMEM_LIMIT = 232448   # one block's dynamic shared memory on an H100


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m,k,n", MATMULS + [(100, 32, 16), (3000, 1040, 272)])
def test_matmul_plan_fits_and_covers_each_tile_once(m, k, n, sms):
    """At every probe shape (and two ragged ones), on an H100 SXM's 132
    SMs and a PCIe card's 114: the ring (at least 3 stages) and the staged
    out tile fit, the tiles cover out once, and the persistent grid hands
    every tile to exactly one block."""
    plan = probe_matmul.plan(m, k, n, sms)
    assert set(plan) == set(probe_matmul.PLAN_FIELDS)
    bm, bn = plan["bm"], plan["bn"]
    assert (bm // 64, bn) in probe_matmul.TILES
    assert plan["threads"] == 128 * (bm // 64 + 1)
    assert plan["stages"] >= 3
    ring = plan["stages"] * (bm + bn) * 64 * 2
    assert ring + bm * bn * 2 <= plan["smem_bytes"] <= SMEM_LIMIT
    assert (plan["tiles_m"] - 1) * bm < m <= plan["tiles_m"] * bm
    assert (plan["tiles_n"] - 1) * bn < n <= plan["tiles_n"] * bn
    tiles = plan["tiles_m"] * plan["tiles_n"]
    assert plan["grid"] == min(tiles, sms)
    taken = sorted(t for blk in range(plan["grid"])
                   for t in range(blk, tiles, plan["grid"]))
    assert taken == list(range(tiles))


def test_matmul_plan_takes_128_tiles_where_they_fill_a_third_of_the_card():
    # 128 x 128 tiles where they make at least sms / 3 tiles: the report
    # shape (784 of them) and (3136, 1024, 256) (50); M = 784 would make 14,
    # so it takes 64 x 64 tiles (52), and so does N = 48 (narrower than 64)
    for m, k, n, tile, grid in ((50176, 1024, 256, (128, 128), 132),
                                (3136, 1024, 256, (128, 128), 50),
                                (784, 1024, 256, (64, 64), 52),
                                (1000, 80, 48, (64, 64), 16)):
        plan = probe_matmul.plan(m, k, n, 132)
        assert (plan["bm"], plan["bn"], plan["grid"]) == (*tile, grid)


def test_matmul_plan_refuses_what_the_kernel_does_not_take():
    for m, k, n in ((0, 16, 16), (64, 24, 16), (64, 16, 40)):
        with pytest.raises(ValueError):
            probe_matmul.plan(m, k, n, 132)


@pytest.mark.cuda
def test_matmul_source_plan_matches_its_mirror():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the plan is asked of the source")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for m, k, n in MATMULS:
        assert probe_matmul.source_plan(m, k, n) == \
            probe_matmul.plan(m, k, n, sms)


# ---------------------------------------------------------------------------
# row 9: tools/probe_fused_block.py
# ---------------------------------------------------------------------------

def _jax_params(c, f, seed):
    """The reference's make_params with non-zero affines (numpy)."""
    p = {k: np.asarray(v, np.float32) for k, v in
         jblock.make_params(jax.random.key(seed), c, f).items()}
    rng = np.random.default_rng(seed)
    for k in ("s1", "b1", "s2", "b2", "s3", "b3"):
        p[k] = (p[k] + rng.normal(size=p[k].shape) * 0.1).astype(np.float32)
    return p


def _numpy_params(c, f, seed):
    """``_jax_params`` from a numpy seed: the port's ``make_params`` (the
    reference's scales) with the same non-zero affines, for the cases that
    run on the card, whose machine has no JAX."""
    p = port_block.make_params(seed, c, f)
    rng = np.random.default_rng(seed)
    for k in ("s1", "b1", "s2", "b2", "s3", "b3"):
        p[k] = (p[k] + rng.normal(size=p[k].shape) * 0.1).astype(np.float32)
    return p


@functools.lru_cache(maxsize=None)
def _block_case(h, c, f, g):
    """(x, params as numpy, and the reference's outputs: 4d, 2d, xla)."""
    p = _jax_params(c, f, h + c + f)
    x = (np.random.default_rng([h, c, f]).normal(size=(N, h, h, c)) * 0.5)
    jx = jnp.asarray(x, jnp.bfloat16)
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k[0] == "w" else jnp.float32)
          for k, v in p.items()}
    with pltpu.force_tpu_interpret_mode():
        out4 = np.asarray(jblock.fused_block(jx, jp, g), np.float32)
        out2 = np.asarray(jblock.fused_block2d(jx, jp, g), np.float32)
    xla = np.asarray(jblock.xla_block(jx, jp), np.float32)
    return np.asarray(jx, np.float32), p, out4, out2, xla


BLOCK_CASES = [(4, 32, 16, 1), (4, 32, 16, 2), (7, 64, 32, 2),
               (7, 128, 64, 2)]


@pytest.mark.parametrize("h,c,f,g", BLOCK_CASES)
@pytest.mark.parametrize("name", ["fused_block", "fused_block2d"])
def test_block_plain_versions_match_the_pallas_kernels(name, h, c, f, g):
    x, p, out4, out2, xla = _block_case(h, c, f, g)
    params = bottleneck_params_from_numpy(p, "cpu")
    want = out4 if name == "fused_block" else out2
    tx = _bf(x)
    for fn in (getattr(bottleneck, name),
               getattr(bottleneck, name + "_reference")):
        got = _np(fn(tx, params, g))
        _close(got, want)
        _close(got, xla)


def test_params_from_numpy_types_and_copies():
    p = {k: np.asarray(v) for k, v in
         jblock.make_params(jax.random.key(0), 32, 16).items()}
    t = bottleneck_params_from_numpy(p, "cpu")
    assert {k: v.dtype for k, v in t.items()} == {
        k: torch.bfloat16 if k[0] == "w" else torch.float32 for k in p}
    assert np.array_equal(t["w2"].float().numpy(), np.asarray(p["w2"],
                                                              np.float32))
    with pytest.raises(ValueError, match="bottleneck params"):
        bottleneck_params_from_numpy({"w1": p["w1"]}, "cpu")


# ---------------------------------------------------------------------------
# row 10: tools/probe_fused_parts.py
# ---------------------------------------------------------------------------

PARTS = ("k_matmuls", "k_pad", "k_mask", "k_folded")
PORT = {"k_matmuls": "block_matmuls", "k_pad": "block_pad",
        "k_mask": "block_mask", "k_folded": "block_folded"}


@functools.lru_cache(maxsize=None)
def _parts_inputs(h, c, f):
    rng = np.random.default_rng([h, c, f, 10])
    x = rng.normal(size=(N * h * h, c)) * 0.3
    w1 = rng.normal(size=(c, f)) * c ** -0.5
    w2 = rng.normal(size=(9, f, f)) * (9 * f) ** -0.5
    w3 = rng.normal(size=(f, c)) * f ** -0.5
    b1, b2 = (rng.normal(size=(1, f)) * 0.1 for _ in range(2))
    b3 = rng.normal(size=(1, c)) * 0.1
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16),  # noqa: E731
                              np.float32)
    return ([bf(a) for a in (x, w1, w2, w3)] +
            [a.astype(np.float32) for a in (b1, b2, b3)])


@functools.lru_cache(maxsize=None)
def _parts_reference(name, h, c, f, g):
    """The reference's ``name`` body through its own ``build``/``build2``,
    with the module's constants at this size."""
    ns = _exec_nodes("tools/probe_fused_parts.py",
                     {"dot", "CP", "wspec", "xspec", "build", "build2",
                      *PARTS}, H=h, C=c, F=f, N=N, G=g, M=g * h * h)
    x, w1, w2, w3, b1, b2, b3 = _parts_inputs(h, c, f)
    j = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        if name == "k_folded":
            out = ns["build2"](ns["k_folded"])(
                j(x), j(w1), jnp.asarray(b1), j(w2), jnp.asarray(b2),
                j(w3), jnp.asarray(b3))
        else:
            out = ns["build"](ns[name], [(9, f, f), (f, c)],
                              scratch=name != "k_matmuls")(
                j(x), j(w1), j(w2), j(w3))
    return np.asarray(out, np.float32)


def _port_parts(name, h, c, f, g, plain):
    x, w1, w2, w3, b1, b2, b3 = _parts_inputs(h, c, f)
    fn = getattr(bottleneck, PORT[name] + ("_reference" if plain else ""))
    tx, tw1, tw2, tw3 = (_bf(a) for a in (x, w1, w2, w3))
    if name == "k_folded":
        out = fn(tx, tw1, torch.tensor(b1), tw2, torch.tensor(b2), tw3,
                 torch.tensor(b3), h=h, g=g)
    else:
        out = fn(tx, tw1, tw2, tw3, h=h, g=g)
    return _np(out)


PARTS_CASES = [(4, 32, 16, 1), (4, 32, 16, 2), (7, 64, 32, 2)]


@pytest.mark.parametrize("h,c,f,g", PARTS_CASES)
@pytest.mark.parametrize("name", PARTS)
def test_parts_plain_versions_match_the_pallas_bodies(name, h, c, f, g):
    want = _parts_reference(name, h, c, f, g)
    for plain in (True, False):
        _close(_port_parts(name, h, c, f, g, plain), want)


@pytest.mark.parametrize("name,leaks", [("k_pad", True), ("k_folded", True),
                                        ("k_mask", False)])
def test_group_size_changes_the_flat_variants_only(name, leaks):
    """At g > 1 the flat padding lets an image's edge rows read the
    neighbouring image (k_pad also wraps at x edges): the reference's
    k_pad and k_folded give other numbers at g = 1 and g = 2, and the port
    the same; k_mask does not."""
    h, c, f = 4, 32, 16
    ref1, ref2 = (_parts_reference(name, h, c, f, g) for g in (1, 2))
    port1, port2 = (_port_parts(name, h, c, f, g, True) for g in (1, 2))
    assert (not np.array_equal(ref1, ref2)) == leaks
    assert (not np.array_equal(port1, port2)) == leaks
    if leaks:   # the rows that differ are the same rows on both sides
        assert np.array_equal(np.any(ref1 != ref2, axis=1),
                              np.any(port1 != port2, axis=1))


def test_fused_block2d_does_not_depend_on_g():
    x, p, _, _, _ = _block_case(4, 32, 16, 1)
    params = bottleneck_params_from_numpy(p, "cpu")
    outs = [_np(bottleneck.fused_block2d(_bf(x), params, g))
            for g in (1, 2, 4)]
    assert all(np.array_equal(outs[0], o) for o in outs[1:])
    _, _, _, ref1, _ = _block_case(4, 32, 16, 1)
    _, _, _, ref2, _ = _block_case(4, 32, 16, 2)
    assert np.array_equal(ref1, ref2)


@pytest.mark.parametrize("name", bottleneck.VARIANTS)
def test_a_group_that_does_not_divide_the_batch_is_refused(name):
    x, p, _, _, _ = _block_case(4, 32, 16, 1)
    params = bottleneck_params_from_numpy(p, "cpu")
    fn = getattr(bottleneck, name)
    with pytest.raises(ValueError, match="must divide the batch"):
        if name.startswith("fused"):
            fn(_bf(x), params, 3)
        elif name == "block_folded":
            fn(_bf(x).reshape(-1, 32), params["w1"], params["b1"],
               params["w2"], params["b2"], params["w3"], params["b3"],
               h=4, g=3)
        else:
            fn(_bf(x).reshape(-1, 32), params["w1"], params["w2"],
               params["w3"], h=4, g=3)


# ---------------------------------------------------------------------------
# rows 9-10: the bottleneck kernel's launch plan (kernels/bottleneck.py
# plan, the mirror of csrc/fused_bottleneck.cu's)
# ---------------------------------------------------------------------------

BLOCK_GS = (1, 2, 4, 8, 16)
# (n, h, C, F): ragged shapes beside the stages: F a multiple of 16 but not
# of 64, short last bands, a group narrower than one 64-row tile, F past
# 512 (y2 in chunks), an image so wide that a band is below 64 rows
RAGGED_BLOCKS = ((8, 14, 1024, 80), (4, 9, 208, 336), (6, 5, 48, 16),
                 (16, 28, 512, 144), (2, 56, 256, 48), (4, 14, 256, 528),
                 (2, 70, 256, 512))


def _covered_rows(plan, n, h, g):
    """Each group's rows in the order the plan's items give them: item i
    is band i // groups of group i % groups (band-major), walked by block
    i % grid."""
    rows = g * h * h
    groups = n // g
    seen = {}
    for blk in range(plan["grid"]):
        for item in range(blk, plan["items"], plan["grid"]):
            band, group = divmod(item, groups)
            r0 = band * plan["band_rows"]
            reff = min(plan["band_rows"], rows - r0)
            assert reff > 0
            seen.setdefault(group, []).extend(range(r0, r0 + reff))
    return seen


@pytest.mark.parametrize("name", bottleneck.VARIANTS)
@pytest.mark.parametrize("shape", [(256, *s) for s in
                                   jblock.STAGES.values()] + list(
                                       RAGGED_BLOCKS))
def test_bottleneck_plan_fits_and_computes_every_row_once(name, shape):
    """At every stage (batch 256) and the ragged shapes, for g in 1..16
    where g divides n: the plan fits a block's 232,448 bytes; every row of
    every group is computed exactly once; y1 holds the band and its halo
    on each side; the band is whole 64-row tiles, the whole group, or
    where no tile fits beside the smallest ring, below 64 rows."""
    n, h, c, f = shape
    for g in [g for g in BLOCK_GS if n % g == 0]:
        plan = bottleneck.plan(name, n, h, c, f, g, 132)
        assert set(plan) == set(bottleneck.PLAN_FIELDS)
        assert plan["smem_bytes"] <= SMEM_LIMIT
        affines = bool(plan["affines_in_smem"])
        assert plan["smem_bytes"] == bottleneck.smem_bytes(
            name, plan["stages"], plan["f_class"], plan["y1_rows"], c, f,
            affines)
        assert plan["f_class"] in (64, 128, 256, 512, 1024)
        assert plan["f_class"] >= f or plan["f_class"] == 1024
        assert plan["stages"] in (2, 3, 4) and plan["threads"] == 256
        halo = 0 if name == "block_matmuls" else h + 1
        band, rows = plan["band_rows"], g * h * h

        def fits(stages, band_rows):
            return bottleneck.smem_bytes(
                name, stages, plan["f_class"], band_rows + 2 * halo, c, f,
                affines) <= SMEM_LIMIT

        if plan["stages"] < 4:   # a fourth stage would cut the band
            assert not fits(4, -(-min(128, rows) // 64) * 64)
        if plan["stages"] < 3:   # so would a third, below 64 rows
            assert not fits(3, min(64, rows)) and band < 64
        if not affines:          # no band fits beside the affines
            assert bottleneck.smem_bytes(name, 2, plan["f_class"],
                                         1 + 2 * halo, c, f) > SMEM_LIMIT
        assert plan["halo"] == halo
        assert band % 64 == 0 or band == rows or band < 64
        assert not fits(plan["stages"], band + 1 if band < 64 else
                        band + 64) or band == rows or band == 1024
        assert plan["y1_rows"] == band + 2 * halo
        assert plan["items"] == n // g * plan["bands"]
        assert plan["grid"] == min(plan["items"], 132)
        seen = _covered_rows(plan, n, h, g)
        assert sorted(seen) == list(range(n // g))
        for group_rows in seen.values():
            assert sorted(group_rows) == list(range(rows))


@pytest.mark.parametrize("stage,band,bands,stages", [("s0", 768, 17, 4),
                                                     ("s1", 256, 13, 4),
                                                     ("s2", 128, 7, 4),
                                                     ("s3", 64, 4, 3)])
def test_bottleneck_plan_at_the_sweeps_g(stage, band, bands, stages):
    """g = 4, batch 256: y1 takes what the ring and the affines leave of
    227 KB (s2: 128 rows of 256 columns and 2 x 15 halo rows beside four
    32 KB stages and 12 KB of affines; at s3 a fourth stage leaves no
    64-row band, so three)."""
    h, c, f = jblock.STAGES[stage]
    plan = bottleneck.plan("fused_block2d", 256, h, c, f, 4, 132)
    assert (plan["band_rows"], plan["bands"], plan["stages"]) == (
        band, bands, stages)
    assert plan["items"] == 64 * bands


@pytest.mark.parametrize("args,code", [
    (("fused_block2d", 256, 14, 1000, 256, 4), -1),
    (("block_pad", 256, 14, 1024, 250, 4), -1),
    (("block_mask", 256, 14, 1024, 256, 3), -2),
    (("block_folded", 0, 14, 1024, 256, 1), -3),
    (("fused_block", 4, 14, 1024, 0, 1), -3),
    (("fused_block", 4, 14, 1024, 4096, 1), -4),
    (("block_matmuls", 4, 14, 16, 131072, 1), -4),
    (("block_pad", 4, 200, 256, 512, 1), -4),
    (("no_such_block", 4, 14, 1024, 256, 1), -5)])
def test_bottleneck_plan_refuses_what_the_kernel_refuses(args, code):
    with pytest.raises(bottleneck.Refused) as info:
        bottleneck.plan(*args, 132)
    assert info.value.code == code
    assert isinstance(info.value, ValueError)


def _mma_sync_kernel_fits(name, h, c, f):
    """Whether the mma.sync kernel this one replaced had room for a band:
    y1 (the band rounded up to 16 rows, with its halo, rounded up to 16)
    and y2 (16 rows at least), row stride F + 8, beside two-deep cp.async
    rings of 32-deep chunks (B up to 256 columns wide, A up to 256 rows)."""
    halo = 0 if name == "block_matmuls" else h + 1

    def tile(width):   # (B columns, A rows) of its 8-warp block tile
        wn = 4 if width > 128 else 2 if width > 64 else 1
        return 64 * wn, 256 // wn

    (nb_f, mb_f), (nb_c, _) = tile(f), tile(c)
    rings = 2 * 32 * (max(nb_f, nb_c) + 8) * 2 + 2 * mb_f * 40 * 2
    ypad = -(-(16 + 2 * halo) // 16) * 16
    return (16 + ypad) * (f + 8) * 2 + rings <= SMEM_LIMIT


@pytest.mark.parametrize("name", bottleneck.VARIANTS)
@pytest.mark.parametrize("c", [16, 256, 2048])
def test_bottleneck_plan_takes_what_the_mma_sync_kernel_took(name, c):
    """Every third F (multiples of 16 up to 2048) and every h up to 112
    (the widest bottleneck of a 448-pixel ResNet input) that the replaced
    kernel had room for has a plan: past F = 512 y2 is made in chunks,
    and where a 64-row band does not fit beside three stages the band
    narrows, the ring drops to two stages, and then the affines leave
    shared memory. (At some F from 80 to 336 that kernel's smaller rings
    also fit images of h >= 119 that this one refuses.)"""
    for f in range(16, 2049, 48):
        for h in range(1, 113):
            if not _mma_sync_kernel_fits(name, h, c, f):
                break
            plan = bottleneck.plan(name, 1, h, c, f, 1, 132)
            assert plan["band_rows"] >= 1


@pytest.mark.cuda
def test_bottleneck_source_plan_matches_its_mirror():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the plan is asked of the source")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in bottleneck.VARIANTS:
        for h, c, f in jblock.STAGES.values():
            for g in (1, 4):
                assert bottleneck.source_plan(name, 256, h, c, f, g) == \
                    bottleneck.plan(name, 256, h, c, f, g, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,c,f,g", [(4, 14, 256, 528, 2),
                                       (2, 70, 256, 512, 1),
                                       (2, 70, 2048, 512, 1)])
def test_bottleneck_kernel_matches_its_plain_version_past_512_and_wide(
        n, h, c, f, g):
    """The six variants against their plain versions on the card where the
    plan leaves the stages' path: F past 512 (y2 in chunks), a band below
    64 rows beside a two-stage ring, and the affines read from global
    memory; max |d| within 1e-2 of the largest, mean within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU route")
    p = bottleneck_params_from_numpy(_numpy_params(c, f, h + f), "cuda")
    rng = np.random.default_rng([n, h, c, f])
    x = _bf(rng.normal(size=(n, h, h, c)) * 0.5).cuda()
    x2 = x.reshape(-1, c)
    w = (p["w1"], p["w2"], p["w3"])
    for name in bottleneck.VARIANTS:
        fn = getattr(bottleneck, name)
        ref = getattr(bottleneck, name + "_reference")
        if name.startswith("fused"):
            got, want = fn(x, p, g), ref(x, p, g)
        elif name == "block_folded":
            args = (p["w1"], p["b1"], p["w2"], p["b2"], p["w3"], p["b3"])
            got, want = fn(x2, *args, h=h, g=g), ref(x2, *args, h=h, g=g)
        else:
            got, want = fn(x2, *w, h=h, g=g), ref(x2, *w, h=h, g=g)
        d = (got.float() - want.float()).abs()
        assert torch.isfinite(got.float()).all()
        assert d.max() <= 1e-2 * want.float().abs().max(), name
        assert d.mean() <= 1e-3 * want.float().abs().mean(), name


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("probe", PORT_PROBES)
def test_importing_a_probe_runs_nothing(probe):
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod = importlib.reload(importlib.import_module(
            f"deeplearning4j_tpu_torch.tools.{probe}"))
    assert buf.getvalue() == ""
    assert callable(mod.main)


@pytest.mark.parametrize("probe", PORT_PROBES)
def test_a_probe_without_cuda_and_no_device_raises(probe, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"deeplearning4j_tpu_torch.tools.{probe}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])


@pytest.mark.parametrize("probe,argv,small", [
    ("probe_matmul", [], dict(SHAPES=[(784, 32, 16), (100, 32, 16)],
                              K_ITERS=1)),
    ("probe_fused_block", ["--stage", "s3", "--batch", "4", "--g", "4",
                           "--k", "1", "--check"], {}),
    ("probe_fused_parts", [], dict(H=4, C=32, F=16, N=4, G=2, K=1)),
])
def test_probes_run_on_the_cpu_when_named(probe, argv, small, capsys,
                                          monkeypatch):
    mod = importlib.import_module(f"deeplearning4j_tpu_torch.tools.{probe}")
    for name, value in small.items():
        monkeypatch.setattr(mod, name, value)
    records = mod.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(records)
    timed = [r for r in records if "ms" in r]
    assert timed and all(r["device"] == "cpu" and r["ms"] > 0 and
                         "frac_of_peak" not in r for r in timed)
    if probe == "probe_matmul":   # the kernel only where bm divides m
        assert [r["path"] for r in records] == ["torch_cpu", "kernel",
                                                "torch_cpu"]
    if probe == "probe_fused_block":
        assert [r["ok"] for r in records if "check" in r] == [True, True]
