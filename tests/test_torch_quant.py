"""The port's quantizers against ``repro.api.quant`` and
``repro.kernels.ref.quantize_acts_int8`` on the same float32 inputs.

Storage and scales must be byte-identical: both sides divide by the scale,
round half to even, clip integer codes to +-127 and cast fp8 codes, on the
same f32 values, so any difference is a bug, not rounding.  Shapes are
ragged so the tile padding (zero storage, scale 1.0) is compared too.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import reduced_configs, reference_params
from repro import api as ref_api
from repro.kernels import ref as ref_kernels
from repro_torch import api
from repro_torch.api import quant
from repro_torch.convert import params_from_jax, tensor_from_numpy
from repro_torch.kernels import ref

SCHEMES = ["int8", "fp8_e4m3"]


def _bytes(a) -> np.ndarray:
    """Storage as raw bytes (fp8 and int8 alike)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.uint8) if a.element_size() == 1 else a).numpy().view(np.uint8)
    a = np.asarray(a)
    return a.view(np.uint8)


def _weights(shape, seed):
    r = np.random.default_rng(seed)
    w = (r.normal(size=shape) * r.uniform(0.1, 3.0, size=shape[-1:])).astype(np.float32)
    w[..., 1] = 0.0  # an all-zero channel takes the floor scale
    return w


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("source", ["natural", "dipweight", "stacked"])
def test_quantize_storage_and_scales_byte_identical(scheme, source):
    shape = (2, 100, 70) if source == "stacked" else (130, 70)
    w = _weights(shape, seed=3)
    if source == "dipweight":
        want = ref_api.quant.quantize(ref_api.DipWeight.from_natural(jnp.asarray(w)), scheme)
        got = quant.quantize(api.DipWeight.from_natural(torch.from_numpy(w)), scheme)
    else:
        want = ref_api.quant.quantize(jnp.asarray(w), scheme)
        got = quant.quantize(torch.from_numpy(w), scheme)
    assert got.data.dtype == quant.scheme_info(scheme).storage_dtype
    assert got.storage_shape == tuple(want.storage_shape) and (got.d_in, got.d_out) == (want.d_in, want.d_out)
    np.testing.assert_array_equal(_bytes(got.data), _bytes(np.asarray(want.data)))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (got.scale[..., w.shape[-1]:] == 1.0).all()
    np.testing.assert_array_equal(got.to_natural().numpy(), np.asarray(want.to_natural()))
    np.testing.assert_array_equal(quant.max_abs_error_bound(got).numpy(),
                                  np.asarray(ref_api.quant.max_abs_error_bound(want)))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_quantize_rows_byte_identical(scheme):
    x = _weights((3, 5, 96), seed=4)
    x[1, 2] = 0.0  # an all-zero row
    wq, ws = ref_api.quant.quantize_rows(jnp.asarray(x), scheme)
    gq, gs = quant.quantize_rows(torch.from_numpy(x), scheme)
    np.testing.assert_array_equal(_bytes(gq), _bytes(np.asarray(wq)))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(quant.dequantize_rows(gq, gs).numpy(),
                                  np.asarray(ref_api.quant.dequantize_rows(wq, ws)))
    np.testing.assert_array_equal(quant.rows_error_bound(gs, scheme).numpy(),
                                  np.asarray(ref_api.quant.rows_error_bound(ws, scheme)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_acts_int8_byte_identical(dtype):
    x = _weights((37, 130), seed=5)
    x[3] = 0.0
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    wq, ws = ref_kernels.quantize_acts_int8(xj)
    gq, gs = ref.quantize_acts_int8(xt)
    assert gq.dtype == torch.int8
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


def test_fp8_numpy_reads_through_bytes():
    w = ref_api.quant.quantize(jnp.asarray(_weights((64, 64), seed=6)), "fp8_e4m3")
    t = tensor_from_numpy(np.asarray(w.data), "cpu")
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bytes(t), _bytes(np.asarray(w.data)))


@pytest.mark.parametrize("scheme", SCHEMES)
def test_params_from_jax_keeps_quantized_weights(scheme):
    ref_cfg, cfg = reduced_configs("xla", "torch", quantization=scheme)
    params, np_params = reference_params(ref_cfg)
    tparams = params_from_jax(np_params, cfg, device="cpu")
    for name, rw, tw in (("lm_head", params["lm_head"], tparams["lm_head"]),
                         ("wq", params["layers"]["wq"], tparams["layers"]["wq"])):
        assert isinstance(tw, api.QuantizedDipWeight), name
        assert (tw.scheme, tw.d_in, tw.d_out, tw.perm_tile) == (rw.scheme, rw.d_in, rw.d_out, rw.perm_tile)
        np.testing.assert_array_equal(_bytes(tw.data), _bytes(np.asarray(rw.data)))
        np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(rw.scale))


def test_requantize_and_astype_point_at_quantize():
    w = torch.from_numpy(_weights((64, 64), seed=7))
    q8 = quant.quantize(w, "int8")
    assert quant.quantize(q8, "int8") is q8
    with pytest.raises(ValueError, match="float checkpoint"):
        quant.quantize(q8, "fp8_e4m3")
    with pytest.raises(TypeError, match="api.quant.quantize"):
        api.DipWeight.from_natural(w).astype(torch.int8)
    with pytest.raises(ValueError, match="unknown quantization scheme"):
        quant.scheme_info("int4")


def test_config_validates_the_scheme():
    _, cfg = reduced_configs("xla", "torch")
    assert cfg.quant_scheme is None
    assert dataclasses.replace(cfg, quantization="int8").quant_scheme == "int8"
    assert dataclasses.replace(cfg, quantization="fp8_e4m3").uses_dip_storage
    with pytest.raises(ValueError, match="unknown quantization scheme"):
        dataclasses.replace(cfg, quantization="int4").quant_scheme


@pytest.mark.parametrize("scheme", SCHEMES)
def test_quantize_params_matches_reference(scheme):
    """The offline calibration step over a whole float model: every DiP
    projection (the lm_head too) quantized, the embedding and norms kept."""
    from repro.models import transformer as ref_tf
    from repro_torch.models import transformer as tf_model

    ref_cfg, cfg = reduced_configs("pallas_dip", "dip")
    params, np_params = reference_params(ref_cfg)
    want = ref_tf.quantize_params(params, scheme)
    got = tf_model.quantize_params(params_from_jax(np_params, cfg, device="cpu"), scheme)
    for name in ("wq", "w_up", "w_down"):
        g, w = got["layers"][name], want["layers"][name]
        assert isinstance(g, api.QuantizedDipWeight) and g.storage_shape == tuple(w.storage_shape)
        np.testing.assert_array_equal(_bytes(g.data), _bytes(np.asarray(w.data)))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
    assert isinstance(got["lm_head"], api.QuantizedDipWeight)
    assert got["embed"].dtype == torch.float32 and not isinstance(got["final_norm"], api.QuantizedDipWeight)
    assert tf_model.quantize_params(got, scheme)["lm_head"] is got["lm_head"]  # already quantized: kept
