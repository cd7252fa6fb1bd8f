"""K7's plain version against the JAX package: numpy ``quantize_int8`` (the
host path) and ``quantize_int8_device`` (the Pallas kernel, in interpret mode
on the CPU). Bit for bit: the saved int8 payload interchanges between the two
packages."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from denseretrievaltoolkits_tpu.index.flat import quantize_int8
from denseretrievaltoolkits_tpu.ops import quant as jquant
from denseretrievaltoolkits_tpu.ops import topk as jtopk
from denseretrievaltoolkits_torch.ops import quant as tquant


def _rows(case):
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(37, 48)) * rng.uniform(0.01, 10, size=(37, 1))).astype(np.float32)
    x[0] = 0  # zero row: scale 1, values 0
    x[1] = 0
    x[1, :4] = [127.0, 2.5, -3.5, 0.5]  # scale exactly 1: ties round half to even
    x[2] = 0
    x[2, :3] = [-254.0, 5.0, -7.0]  # scale 2: x / scale = 2.5, -3.5
    if case == "bfloat16":
        return torch.from_numpy(x).bfloat16()
    return torch.from_numpy(x)


def _scales_match_pallas(scales, js, x):
    """The JAX kernel, run by XLA on the CPU, computes absmax x fl(1/127)
    where numpy divides: its scales sit within one ulp of numpy's (the
    values agree). The port keeps numpy's IEEE division, the payload format's
    contract (ROADMAP queue 3)."""
    np.testing.assert_array_max_ulp(scales, js, maxulp=1)
    absmax = np.abs(x).max(axis=1)
    np.testing.assert_array_equal(js, np.where(absmax == 0, 1, absmax * np.float32(1 / 127.0)))


@pytest.mark.parametrize("case", ["float32", "bfloat16"])
def test_quantize_int8_bit_equal(case):
    x = _rows(case)
    x32 = x.float().numpy()
    values, scales = tquant.quantize_int8_device(x)
    nv, ns = quantize_int8(x32)
    jv, js = jquant.quantize_int8_device(jnp.asarray(x32), block_rows=16)
    assert values.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(values.numpy(), nv)
    np.testing.assert_array_equal(scales.numpy(), ns)
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))
    _scales_match_pallas(scales.numpy(), np.asarray(js), x32)
    assert values[1, :4].tolist() == [127, 2, -4, 0] and values[2, 1:3].tolist() == [2, -4]
    assert scales[0] == 1 and (values[0] == 0).all()


def test_quantize_int8_padding_rows():
    """Rows past the input are the padding the reference's slab pad makes:
    zero values at scale 1, as ``jnp.pad`` then quantize gives."""
    x = _rows("float32")
    values, scales = tquant.quantize_int8_device(x, rows=64)
    padded = np.zeros((64, 48), np.float32)
    padded[:37] = x.numpy()
    jv, js = jquant.quantize_int8_device(jnp.asarray(padded), block_rows=64)
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))
    _scales_match_pallas(scales.numpy(), np.asarray(js), padded)
    with pytest.raises(ValueError, match="rows"):
        tquant.quantize_int8_device(x, rows=10)


def test_quantize_queries_and_dequantize():
    x = _rows("float32")
    qi, qs = tquant.quantize_queries(x)
    jqi, jqs = jtopk.quantize_queries(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(qi.numpy(), np.asarray(jqi))
    _scales_match_pallas(qs.numpy(), np.asarray(jqs), x.numpy())
    np.testing.assert_array_equal(tquant.dequantize_int8(qi, qs).numpy(),
                                  np.asarray(jquant.dequantize_int8(jqi, jnp.asarray(qs.numpy()))))


def test_cpu_tensors_never_launch():
    n = tquant.quantize_int8_device.launches
    tquant.quantize_int8_device(_rows("float32"))
    assert tquant.quantize_int8_device.launches == n
