"""The port's motion estimation against the JAX package's on a 128x64
pan + noise frame pair: MVs, costs and the final luma prediction are
equal.  The JAX side runs jitted, as inside the encoder, so its float32
cost order is the one the port reproduces."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from homerhevc_torch.ops import kernels
from homerhevc_torch.ops import me
from homerhevc_torch.ops import rdbits
from homerhevc_tpu import tables as jtables
from homerhevc_tpu.ops import me as jme

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def frame_pair():
    rng = np.random.default_rng(11)
    h, w = 64, 128
    yy, xx = np.mgrid[0:h + 16, 0:w + 16]
    base = (128 + 70 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
            + rng.normal(0, 8, yy.shape)).clip(0, 255)
    ref = base[4:4 + h, 5:5 + w].astype(np.int32)
    cur = (base[1:1 + h, 7:7 + w] + rng.normal(0, 3, (h, w))).clip(0, 255) \
        .astype(np.int32)
    return cur, ref


def test_motion_estimate_matches_jax(frame_pair):
    """Priced by sqrt(lambda) at QP32, as the P frame calls it."""
    cur, ref = frame_pair
    qp = 32
    sq = jax.jit(lambda q: jnp.sqrt(
        jtables.rd_lambda(q, False).astype(jnp.float32)))
    want = jax.jit(lambda c, r, q: jme.motion_estimate(
        c, r, 16, 2, 2, sqrt_lam=sq(q)))(cur, ref, jnp.int32(qp))
    sqrt_lam = torch.sqrt(rdbits.rd_lambda_f32(torch.tensor(qp), False))
    counts = kernels.launch_counts()
    got = me.motion_estimate(torch.as_tensor(cur), torch.as_tensor(ref),
                             sqrt_lam, block=16, precision=2, subpel_r=2)
    assert kernels.launch_counts() == counts      # CPU: plain versions
    names = ("mv", "cost", "pred")
    for name, g, wv in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv),
                                      err_msg=name)
    assert np.abs(got[0].numpy()).max() > 0       # the pan was found
