"""The port's ABFT layer (``repro_torch.reliability.abft`` and
``api.matmul(..., verify=)``) against the JAX reference on the CPU.

* ``weight_checksum`` equals the reference's within 1e-6 of max(1,
  max|reference|) (the same f32 sums in another order) for ``DipWeight`` in
  f32 and bf16, int8 and fp8 ``QuantizedDipWeight`` and natural tensors,
  2-D and layer-stacked; ``attach_checksums`` stamps each weight once.
* The reference's ``VERIFY_MATRIX`` (10 backend x epilogue x dtype cases,
  the reference test's inputs): the verified output equals the unverified
  call bit for bit, and the report's ``mode``, ``ok`` and ``rows_flagged``
  equal the reference's report on the same inputs.
* Mode selection, the probe-invalid ``ValueError``, a flipped f32 exponent
  bit, a flipped int8 code (caught by the exact storage compare, inside the
  probe's tolerance) and a planted NaN: flagged as the reference flags them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import assert_close
from repro import api as ref_api
from repro import reliability as ref_rel
from repro_torch import api, reliability as rel

# the reference test's matrix (tests/test_reliability.py): one cell per
# backend family x epilogue class x coarse dtype
VERIFY_MATRIX = [
    ("xla", "none", "float32"),
    ("xla", "bias", "float32"),
    ("ws", "none", "bfloat16"),
    ("ws", "swiglu", "float32"),
    ("pallas_dip", "none", "float32"),
    ("pallas_dip", "bias", "bfloat16"),
    ("pallas_systolic", "residual", "float32"),
    ("dip_int8w", "none", "float32"),
    ("dip_int8w", "bias_gelu", "bfloat16"),
    ("dip_fp8", "none", "float32"),
]
CHECKSUM_TOL = 1e-6


def _ref_weight(backend, w):
    be = ref_api.get_backend(backend)
    if be.layout == "dip_q":
        return ref_api.quant.quantize(jnp.asarray(w, jnp.float32), be.scheme)
    if be.layout == "dip":
        return ref_api.DipWeight.from_natural(jnp.asarray(w))
    return jnp.asarray(w)


def _port_weight(backend, w):
    be = api.get_backend(backend)
    t = torch.from_numpy(w)
    if be.layout == "dip_q":
        return api.quant.quantize(t, be.scheme)
    if be.layout == "dip":
        return api.DipWeight.from_natural(t)
    return t


def _inputs(backend, epilogue, dtype, m=16, k=64, n=64, seed=0):
    """The reference test's inputs, built on both sides from one numpy draw,
    checksums attached: ``(ref x, w, ops), (port x, w, ops)``."""
    r = np.random.default_rng(seed)
    x = r.normal(0, 1, (m, k)).astype(np.float32)
    wg = r.normal(0, 1, (k, n)).astype(np.float32)
    wu = r.normal(0, 1, (k, n)).astype(np.float32)
    if epilogue == "swiglu":
        ws, ops = (wg, wu), ()
    elif epilogue.startswith("bias"):
        ws, ops = wg, (r.normal(0, 1, (n,)).astype(np.float32),)
    elif epilogue == "residual":
        ws, ops = wg, (r.normal(0, 1, (m, n)).astype(np.float32),)
    else:
        ws, ops = wg, ()
    if isinstance(ws, tuple):
        rw, pw = tuple(_ref_weight(backend, w) for w in ws), tuple(_port_weight(backend, w) for w in ws)
    else:
        rw, pw = _ref_weight(backend, ws), _port_weight(backend, ws)
    ref = (jnp.asarray(x).astype(dtype), ref_rel.attach_checksums(rw), tuple(jnp.asarray(o) for o in ops))
    tdt = getattr(torch, dtype)
    port_ops = tuple(torch.from_numpy(o).to(tdt) if o.ndim == 2 else torch.from_numpy(o) for o in ops)
    port = (torch.from_numpy(x).to(tdt), _attach(pw), port_ops)
    return ref, port


def _attach(w):
    if isinstance(w, tuple):
        return tuple(rel.attach_checksums(wi) for wi in w)
    return rel.attach_checksums(w)


def _report_fields(rep):
    return rep["mode"], bool(rep["ok"]), int(rep["rows_flagged"])


def _bytes(t) -> np.ndarray:
    """A tensor's or array's raw bytes as a uint8 numpy array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().contiguous()
        return t.view(torch.uint8).numpy().reshape(-1) if t.element_size() == 1 else \
            t.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy().view(np.uint8).reshape(-1)
    a = np.ascontiguousarray(np.asarray(t))
    return a.view(np.uint8).reshape(-1)


# ------------------------------------------------------------- checksums --
def _checksum_pairs(kind, stacked):
    r = np.random.default_rng(3)
    shape = (3, 96, 80) if stacked else (96, 80)  # not 64-multiples: padded storage
    w = r.normal(0, 1, shape).astype(np.float32)
    if kind in ("dip_f32", "dip_bf16"):
        dt = "float32" if kind == "dip_f32" else "bfloat16"
        ref = ref_api.DipWeight.from_natural(jnp.asarray(w).astype(dt))
        port = api.DipWeight.from_natural(torch.from_numpy(w).to(getattr(torch, dt)))
    elif kind in ("int8", "fp8_e4m3"):
        ref = ref_api.quant.quantize(jnp.asarray(w), kind)
        port = api.quant.quantize(torch.from_numpy(w), kind)
    else:
        ref, port = jnp.asarray(w), torch.from_numpy(w)
    return ref, port


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("kind", ["dip_f32", "dip_bf16", "int8", "fp8_e4m3", "natural"])
def test_weight_checksum_matches_reference(kind, stacked):
    ref_w, port_w = _checksum_pairs(kind, stacked)
    want, got = ref_rel.weight_checksum(ref_w), rel.weight_checksum(port_w)
    for field in rel.AbftChecksum._fields:
        a, b = getattr(got, field), getattr(want, field)
        if b is None:
            assert a is None, field
            continue
        assert a.dtype == torch.float32, field
        assert_close(a, np.asarray(b), CHECKSUM_TOL)
    stamped = rel.attach_checksums({"w": port_w, "n": torch.ones(2)})
    if isinstance(port_w, torch.Tensor):
        assert stamped["w"] is port_w  # natural tensors carry no child
    else:
        assert stamped["w"].checksum is not None and rel.attach_checksums(stamped)["w"] is stamped["w"]


def test_weight_checksum_of_stacked_is_its_slices():
    """A stacked weight's checksum is its layer slices' checksums stacked
    (it is computed one slice at a time)."""
    _, port_w = _checksum_pairs("int8", True)
    whole = rel.weight_checksum(port_w)
    for i in range(port_w.data.shape[0]):
        part = rel.weight_checksum(port_w.with_data(port_w.data[i], port_w.scale[i]))
        for a, b in zip(part, whole):
            assert torch.equal(a, b[i])


# ---------------------------------------------------------- no observer ---
@pytest.mark.parametrize("backend,epilogue,dtype", VERIFY_MATRIX)
def test_verified_is_bit_identical_and_reports_as_reference(backend, epilogue, dtype):
    (rx, rw, rops), (x, w, ops) = _inputs(backend, epilogue, dtype)
    plain = api.matmul(x, w, backend=backend, epilogue=epilogue, epilogue_operands=ops)
    out, report = api.matmul(x, w, backend=backend, epilogue=epilogue, epilogue_operands=ops, verify=True)
    assert out.dtype == plain.dtype and np.array_equal(_bytes(out), _bytes(plain))
    assert bool(report["ok"]), (backend, epilogue, dtype, report)
    _, ref_report = ref_api.matmul(rx, rw, backend=backend, epilogue=epilogue, epilogue_operands=rops, verify=True)
    assert _report_fields(report) == _report_fields(ref_report)
    for key in ("ok", "finite", "checksum_ok", "rows_flagged", "max_excess"):
        assert isinstance(report[key], torch.Tensor) and report[key].dim() == 0, key
    assert float(report["max_excess"]) <= 0.0
    rel.raise_on_fault(report)  # a clean report does not raise


def test_probe_mode_selection():
    """auto: the probe exactly where the row-sum identity holds; an
    explicit probe elsewhere is the caller's error, as in the reference."""
    _, (x, w, _) = _inputs("pallas_dip", "none", "float32")
    assert api.matmul(x, w, backend="pallas_dip", verify=True)[1]["mode"] == "probe"
    assert api.matmul(x, w, backend="pallas_dip", verify="storage")[1]["mode"] == "storage"
    _, (xs, wsw, _) = _inputs("pallas_dip", "swiglu", "float32")
    assert api.matmul(xs, wsw, backend="pallas_dip", epilogue="swiglu", verify=True)[1]["mode"] == "storage"
    with pytest.raises(ValueError, match="probe verification is invalid"):
        api.matmul(xs, wsw, backend="pallas_dip", epilogue="swiglu", verify="probe")
    g = torch.ones(64)
    rep = api.matmul(x, w, backend="dip", prologue="rmsnorm", prologue_operands=(g,), verify=True)[1]
    assert rep["mode"] == "storage" and bool(rep["ok"])  # a fused prologue rewrites x
    with pytest.raises(ValueError, match="mode must be"):
        api.matmul(x, w, backend="dip", verify="sometimes")
    assert all(api.get_backend(b).abft for b in api.list_backends())


# ------------------------------------------------------------- detection --
def test_probe_detects_weight_bitflip_as_reference():
    (rx, rw, _), (x, w, _) = _inputs("pallas_systolic", "none", "float32")
    bad = rel.bitflip(w.data, seed=3, bit=30)  # an exponent bit: loud
    ref_bad = ref_rel.bitflip(rw.data, seed=3, bit=30)
    assert np.array_equal(_bytes(bad), _bytes(ref_bad))
    out, rep = api.matmul(x, w.with_data(bad, checksum=w.checksum), backend="pallas_systolic", verify=True)
    _, ref_rep = ref_api.matmul(rx, rw.with_data(jnp.asarray(ref_bad), checksum=rw.checksum),
                                backend="pallas_systolic", verify=True)
    assert not bool(rep["ok"]) and int(rep["rows_flagged"]) > 0
    assert _report_fields(rep) == _report_fields(ref_rep)
    with pytest.raises(rel.ReliabilityError, match="ABFT verification failed"):
        rel.raise_on_fault(rep)
    assert not torch.equal(bad, w.data)  # bitflip left its input untouched


def test_storage_compare_detects_quant_code_flip_as_reference():
    """One int8 code flip hides inside the W8A8 probe tolerance; the exact
    storage compare catches it, in both modes."""
    (rx, rw, _), (x, w, _) = _inputs("dip_int8w", "none", "float32")
    bad = rel.bitflip(w.data, seed=5, bit=6)
    ref_bad = jnp.asarray(ref_rel.bitflip(rw.data, seed=5, bit=6))
    assert np.array_equal(_bytes(bad), _bytes(ref_bad))
    qc = w.with_data(bad, w.scale, checksum=w.checksum)
    ref_qc = rw.with_data(ref_bad, rw.scale, checksum=rw.checksum)
    for mode in ("storage", True):
        _, rep = api.matmul(x, qc, backend="dip_int8w", verify=mode)
        _, ref_rep = ref_api.matmul(rx, ref_qc, backend="dip_int8w", verify=mode)
        assert not bool(rep["ok"]) and not bool(rep["checksum_ok"])
        assert _report_fields(rep) == _report_fields(ref_rep)


def test_fp8_code_flip_flagged_by_storage_compare():
    _, (x, w, _) = _inputs("dip_fp8", "none", "float32")
    bad = rel.bitflip(w.data, seed=9, bit=6)
    _, rep = api.matmul(x, w.with_data(bad, w.scale, checksum=w.checksum), backend="dip_fp8", verify="storage")
    assert not bool(rep["ok"]) and bool(rep["finite"])


def test_planted_nan_output_flagged_as_reference():
    (rx, rw, _), (x, w, _) = _inputs("xla", "none", "float32")
    xn, ref_xn = rel.plant_nan(x, seed=0), ref_rel.plant_nan(rx, seed=0)
    assert np.array_equal(_bytes(xn), _bytes(ref_xn))
    out, rep = api.matmul(xn, w, backend="xla", verify=True)
    _, ref_rep = ref_api.matmul(jnp.asarray(ref_xn), rw, backend="xla", verify=True)
    assert not bool(rep["finite"]) and not bool(rep["ok"])
    assert _report_fields(rep) == _report_fields(ref_rep)


def test_checksum_converted_from_reference_verifies_clean():
    """A reference ``AbftChecksum`` carried across by ``params_from_jax``'s
    converter audits the port's dispatch clean, and flags a flip."""
    import jax
    from repro_torch.convert import _convert

    (rx, rw, _), (x, _, _) = _inputs("pallas_dip", "none", "float32")
    w = _convert(jax.tree_util.tree_map(np.asarray, {"w": rw})["w"], torch.device("cpu"))
    assert isinstance(w.checksum, rel.AbftChecksum) and w.checksum.scale_col is None
    assert bool(api.matmul(x, w, backend="dip", verify=True)[1]["ok"])
    bad = w.with_data(rel.bitflip(w.data, seed=1, bit=30), checksum=w.checksum)
    assert not bool(api.matmul(x, bad, backend="dip", verify="storage")[1]["ok"])


@pytest.mark.parametrize("backend", ["torch", "ws", "dip", "systolic", "dip_int8w", "dip_fp8"])
def test_nan_activation_row_flags_that_row_only(backend):
    """One NaN in row 3 of x: that output row is NaN (the int8 route's
    per-row scale takes it), the other rows equal the clean call's, and the
    probe flags one row."""
    _, (x, w, _) = _inputs({"torch": "xla", "systolic": "pallas_systolic", "dip": "pallas_dip"}.get(backend, backend),
                           "none", "float32")
    clean = api.matmul(x, w, backend=backend)
    xn = x.clone()
    xn[3, 10] = float("nan")
    out, rep = api.matmul(xn, w, backend=backend, verify=True)
    assert torch.isnan(out[3]).all() and torch.isfinite(out[torch.arange(16) != 3]).all()
    assert torch.equal(out[:3], clean[:3]) and torch.equal(out[4:], clean[4:])
    assert not bool(rep["ok"]) and int(rep["rows_flagged"]) == 1 and rep["mode"] == "probe"
