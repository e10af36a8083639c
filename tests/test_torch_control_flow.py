"""The port's SameDiff control flow against the JAX package's.

The 15 tests of ``tests/test_control_flow.py`` (whileLoop, ifCond, scan,
forLoop, and graphs holding them through save/load, captured constants,
untraceable bodies and the capture errors), each written once over a
package's API and run on both packages: the reference's assertions hold
on each, and the arrays each returns agree exactly (float32 on the CPU;
the loops add and multiply small integers). The port runs the bodies as
Python loops, and autograd runs through them.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JaxSameDiff
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff

JAX = SimpleNamespace(create=JaxSameDiff.create,
                      load=JaxSameDiff.load, f32=jnp.float32,
                      all=jnp.all)
PORT = SimpleNamespace(create=lambda: SameDiff.create(device="cpu"),
                       load=lambda p: SameDiff.load(p, device="cpu"),
                       f32=torch.float32, all=torch.all)


def _val(res, var):
    return res[var.name()].numpy()


# -- TestWhileLoop -------------------------------------------------------------

def while_countdown_sum(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32, 1)
    acc0 = sd.constant("acc0", np.zeros(1, np.float32))
    final_v, final_acc = sd.whileLoop(
        lambda v, acc: (v > 0).all(),
        lambda v, acc: (v - 1.0, acc + v),
        x, acc0, name="loop")
    res = sd.output({"x": np.array([5.0], np.float32)}, final_acc.name())
    assert float(_val(res, final_acc)[0]) == 15.0
    return {"acc": _val(res, final_acc)}


def while_single_var(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32)
    doubled = sd.whileLoop(lambda v: (v < 100).all(),
                           lambda v: (v * 2.0,), x)
    res = sd.output({"x": np.float32(3.0)}, doubled.name())
    assert float(_val(res, doubled)) == 192.0
    return {"v": _val(res, doubled)}


# -- TestIfCond ----------------------------------------------------------------

def if_branches(P, tmp):
    sd = P.create()
    p = sd.placeHolder("p", P.f32)
    x = sd.placeHolder("x", P.f32, 3)
    y = sd.ifCond(p, lambda a: a * 2.0, lambda a: a - 1.0, x)
    xs = np.array([1.0, 2.0, 3.0], np.float32)
    hi = sd.output({"p": np.float32(1), "x": xs}, y.name())
    lo = sd.output({"p": np.float32(0), "x": xs}, y.name())
    np.testing.assert_allclose(_val(hi, y), xs * 2)
    np.testing.assert_allclose(_val(lo, y), xs - 1)
    return {"hi": _val(hi, y), "lo": _val(lo, y)}


def if_cond_is_differentiable(P, tmp):
    sd = P.create()
    p = sd.constant("p", np.float32(1.0))
    x = sd.placeHolder("x", P.f32, 3)
    y = sd.ifCond(p, lambda a: a * a, lambda a: a, x, name="branch")
    y.sum().markAsLoss()
    xs = np.array([1.0, 2.0, 3.0], np.float32)
    g = sd.calculateGradients({"x": xs}, "x")["x"].numpy()
    np.testing.assert_allclose(g, 2 * xs)  # chose the square branch
    return {"g": g}


# -- TestScan ------------------------------------------------------------------

def scan_cumulative_carry(P, tmp):
    sd = P.create()
    xs = sd.placeHolder("xs", P.f32, 4)
    init = sd.constant("c0", np.float32(0.0))
    carry, ys = sd.scan(lambda c, x: (c + x, c + x), init, xs, name="cumsum")
    data = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    res = sd.output({"xs": data}, carry.name(), ys.name())
    assert float(_val(res, carry)) == 10.0
    np.testing.assert_allclose(_val(res, ys), np.cumsum(data))
    return {"carry": _val(res, carry), "ys": _val(res, ys)}


def scan_gradient(P, tmp):
    sd = P.create()
    xs = sd.placeHolder("xs", P.f32, 3)
    init = sd.constant("c0", np.float32(1.0))
    carry, _ys = sd.scan(lambda c, x: (c * x, c), init, xs)
    carry.markAsLoss()
    data = np.array([2.0, 3.0, 4.0], np.float32)
    g = sd.calculateGradients({"xs": data}, "xs")["xs"].numpy()
    np.testing.assert_allclose(g, 24.0 / data)   # d(prod)/dx_i
    return {"g": g}


# -- TestForLoop ---------------------------------------------------------------

def for_fixed_iterations(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32)
    out = sd.forLoop(4, lambda i, v: (v + 10.0 ** 0 * (i + 1),), x)
    res = sd.output({"x": np.float32(0.0)}, out.name())
    assert float(_val(res, out)) == 10.0  # 1+2+3+4
    return {"v": _val(res, out)}


# -- TestControlFlowSerialization ------------------------------------------------

def while_loop_round_trips(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32, 1)
    acc0 = sd.constant("acc0", np.zeros(1, np.float32))
    out = sd.whileLoop(
        lambda v, acc: (v > 0).all(),
        lambda v, acc: (v - 1.0, acc + v),
        x, acc0, name="loop")
    final_acc = out[1]
    p = str(tmp / "g.sd")
    sd.save(p)
    sd2 = P.load(p)
    feeds = {"x": np.array([5.0], np.float32)}
    a = _val(sd.output(feeds, final_acc.name()), final_acc)
    b = _val(sd2.output(feeds, final_acc.name()), final_acc)
    np.testing.assert_allclose(a, b)
    assert float(b[0]) == 15.0
    return {"b": b}


def scan_and_ifcond_round_trip(P, tmp):
    sd = P.create()
    init = sd.constant("init", np.float32(0.0))
    xs = sd.placeHolder("xs", P.f32, 4)
    carry, ys = sd.scan(lambda c, x: (c + x, c * 2.0), init, xs, name="cum")
    p = sd.placeHolder("p", P.f32)
    branch = sd.ifCond(p, lambda a: a * 10.0, lambda a: a - 1.0,
                       carry, name="branch")
    path = str(tmp / "g2.sd")
    sd.save(path)
    sd2 = P.load(path)
    feeds = {"xs": np.arange(4, dtype=np.float32), "p": np.float32(1)}
    out = {}
    for tag, g in (("sd", sd), ("sd2", sd2)):
        res = g.output(feeds, branch.name(), ys.name())
        assert float(_val(res, branch)) == 60.0
        np.testing.assert_allclose(_val(res, ys), [0.0, 0.0, 2.0, 6.0])
        out[f"{tag}.branch"] = _val(res, branch)
        out[f"{tag}.ys"] = _val(res, ys)
    return out


def for_loop_round_trips(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32)
    out = sd.forLoop(3, lambda i, v: (v * 2.0,), x)
    p = str(tmp / "g3.sd")
    sd.save(p)
    r = P.load(p).output({"x": np.float32(1.0)}, out.name())
    assert float(_val(r, out)) == 8.0
    return {"v": _val(r, out)}


def captured_outer_constant_round_trips(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32)
    step = sd.constant("step", np.float32(2.5))
    # the body closes over an OUTER graph constant -> captured-constant
    # table in the sub-graph
    out = sd.forLoop(2, lambda i, v: (v + step,), x)
    p = str(tmp / "g4.sd")
    sd.save(p)
    r = P.load(p).output({"x": np.float32(1.0)}, out.name())
    assert float(_val(r, out)) == pytest.approx(6.0)
    return {"v": _val(r, out)}


def untraceable_body_runs_but_save_raises(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32)
    # a package function inside the body escapes the SDVariable surface:
    # it still runs (raw-callable fallback) but cannot serialize
    out = sd.whileLoop(lambda v: P.all(v < 100.0), lambda v: (v * 2.0,), x)
    r = sd.output({"x": np.float32(3.0)}, out.name())
    assert float(_val(r, out)) == 192.0
    with pytest.raises(ValueError, match="could not be traced"):
        sd.save(str(tmp / "g5.sd"))
    return {"v": _val(r, out)}


def reversed_operand_capture_round_trips(P, tmp):
    """outer_const + loop_var (captured var on the LEFT) must trace onto
    the child graph exactly like loop_var + outer_const."""
    sd = P.create()
    x = sd.placeHolder("x", P.f32)
    step = sd.constant("step", np.float32(2.5))
    out = sd.forLoop(2, lambda i, v: (step + v,), x)
    p = str(tmp / "g6.sd")
    sd.save(p)
    r = P.load(p).output({"x": np.float32(1.0)}, out.name())
    assert float(_val(r, out)) == pytest.approx(6.0)
    # the parent graph must NOT have been polluted with capture vars
    assert not any(n.startswith("__cap_") for n in sd._vars)
    return {"v": _val(r, out)}


def capturing_trainable_variable_raises(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32)
    w = sd.var("w", np.ones((), np.float32))
    # snapshotting a trainable var would silently freeze it in the body
    with pytest.raises(ValueError, match="freeze"):
        sd.forLoop(2, lambda i, v: (v * w,), x)
    return {}


def capturing_placeholder_raises_at_build(P, tmp):
    sd = P.create()
    x = sd.placeHolder("x", P.f32)
    y = sd.placeHolder("y", P.f32)
    # a body capturing an outer PLACEHOLDER (no build-time value) can work
    # neither traced nor as a raw callable -> a clear build error
    with pytest.raises(ValueError, match="explicit loop variables"):
        sd.forLoop(2, lambda i, v: (v + y,), x)
    return {}


CASES = [
    while_countdown_sum, while_single_var, if_branches,
    if_cond_is_differentiable, scan_cumulative_carry, scan_gradient,
    for_fixed_iterations, while_loop_round_trips,
    scan_and_ifcond_round_trip, for_loop_round_trips,
    captured_outer_constant_round_trips,
    untraceable_body_runs_but_save_raises,
    reversed_operand_capture_round_trips,
    capturing_trainable_variable_raises,
    capturing_placeholder_raises_at_build,
]


def test_cases_are_the_reference_tests():
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parent /
                      "test_control_flow.py").read_text())
    names = [n.name for n in ast.walk(tree)
             if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")]
    assert len(names) == len(CASES) == 15
    mine = {c.__name__ for c in CASES}
    for n in names:
        assert any(n[len("test_"):] in m or m.endswith(n[len("test_"):])
                   for m in mine), n


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_control_flow_case_on_both_packages(case, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = case(JAX, tmp_path / "jax")
    got = case(PORT, tmp_path / "torch")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_loops_differentiate_through_every_iteration():
    """whileLoop and forLoop bodies are Python loops, so autograd runs
    through them (the reference's whileLoop is forward-only); the
    gradients agree with the same product written out."""
    sd = SameDiff(device="cpu")
    x = sd.placeHolder("x", torch.float32, 3)
    w = sd.constant("w", np.float32(1.5))
    out = sd.forLoop(3, lambda i, v: (v * w + 1.0,), x)
    v, n = sd.whileLoop(lambda v, n: (n < 2.0).all(),
                        lambda v, n: (v * v, n + 1.0), out,
                        sd.constant("n0", np.float32(0.0)))
    v.sum().markAsLoss()
    xs = np.array([0.5, -1.0, 0.25], np.float32)
    g = sd.calculateGradients({"x": xs}, "x")["x"].numpy()
    t = torch.from_numpy(xs).double().requires_grad_(True)
    y = t
    for _ in range(3):
        y = y * 1.5 + 1.0
    (y ** 4).sum().backward()
    np.testing.assert_allclose(g, t.grad.numpy(), rtol=1e-6)
