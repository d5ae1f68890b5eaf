"""K7's warp programs (ops/warp_program.py) run step by step on the CPU:
each step reads every operand before it writes any result, as the warp's
lanes do between two barriers, so an operation that read a slot of its own
step would fail here. The doubling and the add must give the port's
sequential formulas (curves/jacobian.py) bit for bit, and the affine points
of the JAX package's host curve."""

import numpy as np
import pytest
import torch

from keyless_zk_tpu_torch.curves.jacobian import JacPoint
from keyless_zk_tpu_torch.fields import torch_field as tf
from keyless_zk_tpu_torch.fields.torch_field import FQ
from keyless_zk_tpu_torch.ops import cuda_msm, warp_program as wp
from torch_fixtures import GROUPS, points_with_dlogs

torch.set_num_threads(1)


FN = {wp.MUL: tf.mont_mul, wp.ADD: tf.add, wp.SUB: tf.sub}


def run_steps(steps, slots: dict) -> None:
    for step in steps:
        assert 0 < len(step) <= wp.LANES
        results = [(dst, FN[kind](slots[a], slots[b], FQ)) for kind, dst, a, b in step]
        for dst, v in results:
            assert dst not in slots
            slots[dst] = v


def _fq_elems(p, tag):
    """JacPoint (n, 16) or (n, 2, 16) coordinates -> list of (n, 16) Fq elements, x y z order."""
    out = []
    for c in p:
        out.extend([c] if tag == "fq" else [c[:, 0], c[:, 1]])
    return out


def _point(elems, tag):
    if tag == "fq":
        return JacPoint(*elems)
    return JacPoint(*(torch.stack(elems[2 * i : 2 * i + 2], dim=1) for i in range(3)))


@pytest.mark.parametrize("tag", ["fq", "fq2"])
def test_warp_programs_match_formulas(tag):
    rng = np.random.default_rng(9)
    curve = cuda_msm.curve_for(tag)
    n = 6
    pts, dlogs = points_with_dlogs(tag, 3 * n, rng)
    x, y, inf = curve.encode_affine(pts)
    aff = curve.from_affine(x, y, inf)
    part = [JacPoint(*(c[i * n : (i + 1) * n] for c in aff)) for i in range(3)]
    p = curve.dbl(part[0])  # z != 1
    q = curve.add(part[1], part[2])
    progs = wp.programs(tag)

    slots = dict(enumerate(_fq_elems(p, tag) + _fq_elems(q, tag)))
    run_steps(progs["dbl"]["steps"], slots)
    got = _point([slots[i] for i in progs["dbl"]["out"]], tag)
    want = curve.dbl(p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    slots = dict(enumerate(_fq_elems(p, tag) + _fq_elems(q, tag)))
    run_steps(progs["add"]["steps"], slots)
    got = _point([slots[i] for i in progs["add"]["out"]], tag)
    want, h, rr = curve.add_formula(p, q)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(torch.stack([slots[i] for i in progs["add"]["h"]], -2).reshape(h.shape), h)
    assert torch.equal(torch.stack([slots[i] for i in progs["add"]["rr"]], -2).reshape(rr.shape), rr)

    group, gen = GROUPS[tag]
    dec = curve.decode_jacobian(got)
    for i in range(n):
        kp = 2 * dlogs[i]
        assert dec[i] == group.mul(gen, kp + dlogs[n + i] + dlogs[2 * n + i])


@pytest.mark.parametrize("tag", ["fq", "fq2"])
def test_warp_program_shape(tag):
    """Products and adds never share a step (a warp would run them one
    after the other); a doubling takes 3 product steps and an add 5, with
    up to 7 (doubling) and 12 (add) Fq products in a step at G2; the
    encoded program decodes to the same steps and fits the kernel's
    buffers."""
    progs = wp.programs(tag)
    for name, mul_steps, widest in (("dbl", 3, (3, 7)), ("add", 5, (5, 12))):
        steps = progs[name]["steps"]
        kinds = [{op[0] == wp.MUL for op in step} for step in steps]
        assert all(len(k) == 1 for k in kinds)
        muls = [len(step) for step, k in zip(steps, kinds) if k == {True}]
        assert len(muls) == mul_steps and max(muls) == widest[tag == "fq2"]
        assert progs[name]["slots"] <= wp.SLOTS
    code = wp.encode(tag).view(np.uint32)
    n_dbl, n_add = int(code[wp.H_DBL_STEPS]), int(code[wp.H_ADD_STEPS])
    assert (n_dbl, n_add) == (len(progs["dbl"]["steps"]), len(progs["add"]["steps"]))
    assert code.size == wp.HEADER + wp.LANES * (n_dbl + n_add) <= wp.CODE_MAX
    words = code[wp.HEADER :].reshape(-1, wp.LANES)
    for s, step in enumerate(progs["dbl"]["steps"] + progs["add"]["steps"]):
        for lane in range(wp.LANES):
            w = int(words[s, lane])
            got = (w >> 30, (w >> 20) & 1023, (w >> 10) & 1023, w & 1023)
            assert got == (step[lane] if lane < len(step) else (0,) * 4)
