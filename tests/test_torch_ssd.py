"""The port's SSD chunk scan against the JAX package on the same inputs.

On the CPU ``repro_torch.kernels.ssd.ssd_fused`` runs its plain version,
``ssd_fused_plain``; these tests hold it against the Pallas kernel (in
interpret mode, as tests/test_kernels.py runs it), the sequential oracle
``ssd_ref`` and the XLA chunked scan ``ssd_scan``, at the reference's own
test shapes. Tolerances: float32 rtol = atol = 1e-4, the reference's own
(the sums run in another order); outputs in bfloat16 within one bfloat16
rounding step (rtol 2^-7).

The CUDA kernel against its plain version, on the card, is in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ssd_fused as ref_ssd_fused
from repro.models.ssm import ssd_scan as ref_ssd_scan
from repro_torch.kernels.ssd import ssd_fused, ssd_fused_plain
from test_torch_cuda import SSD_SHAPES, ssd_inputs

REF_SHAPES = SSD_SHAPES[:3]      # tests/test_kernels.py's shapes
TOL = 1e-4


def _reference(kind, args, chunk):
    ja = [jnp.asarray(a.float().numpy(), jnp.float32)
          if a.dtype == torch.float32 else
          jnp.asarray(a.float().numpy(), jnp.bfloat16) for a in args]
    if kind == "pallas":
        return ref_ssd_fused(*ja, chunk=chunk, use_kernel=True,
                             interpret=True)
    if kind == "oracle":
        return ref_ssd_fused(*ja, chunk=chunk, use_kernel=False)
    return ref_ssd_scan(*ja, chunk=chunk)


@pytest.mark.parametrize("kind", ["pallas", "oracle", "scan"])
@pytest.mark.parametrize("shape", REF_SHAPES, ids=str)
def test_plain_matches_reference(shape, kind):
    b, s, H, P, G, N, chunk = shape
    args = ssd_inputs(sum(shape), b, s, H, P, G, N)
    y, h = ssd_fused(*args, chunk=chunk)
    yr, hr = _reference(kind, args, chunk)
    assert y.dtype == torch.float32 and tuple(h.shape) == (b, H, P, N)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", ["pallas", "oracle"])
def test_plain_matches_reference_bf16(kind):
    """bfloat16 x, B and C (the serving path's types): y in bfloat16
    within one rounding step, the float32 state within 1e-4."""
    b, s, H, P, G, N, chunk = 1, 32, 2, 8, 1, 16, 16
    bf = torch.bfloat16
    args = ssd_inputs(0, b, s, H, P, G, N, dtype=bf, bc_dtype=bf)
    y, h = ssd_fused(*args, chunk=chunk)
    yr, hr = _reference(kind, args, chunk)
    assert y.dtype == bf and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(yr, np.float32),
                               rtol=2 ** -7, atol=TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=TOL, atol=TOL)


def test_cpu_tensors_take_the_plain_version():
    b, s, H, P, G, N, chunk = SSD_SHAPES[0]
    args = ssd_inputs(3, b, s, H, P, G, N)
    before = ssd_fused.launches
    y, h = ssd_fused(*args, chunk=chunk)
    yp, hp = ssd_fused_plain(*args, chunk=chunk)
    assert ssd_fused.launches == before
    assert torch.equal(y, yp) and torch.equal(h, hp)


def test_malformed_inputs_raise():
    args = list(ssd_inputs(0, 1, 16, 4, 8, 2, 16))
    bad_dt = args[:1] + [args[1][:, :8]] + args[2:]
    with pytest.raises(ValueError, match="dt"):
        ssd_fused(*bad_dt, chunk=8)
    three_groups = ssd_inputs(0, 1, 16, 4, 8, 3, 16)
    with pytest.raises(ValueError, match="groups"):
        ssd_fused(*three_groups, chunk=8)
