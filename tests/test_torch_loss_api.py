"""The losses' reference API against the JAX package's (CPU, f32).

``VGGishFeatureLoss``, ``LPIPSLoss``, ``perceptual_loss`` and
``gram_matrix`` on the inputs of the JAX suite's own behaviour list
(``tests/test_losses.py``: 128 x 128 images), with the JAX
``VGGishFeatureLoss(seed=0)`` and ``LPIPSLoss(seed=0)`` weights carried
across (``interop/flax_weights.py load_flax_convs``).  On the CPU the
VGGish loss resolves to its plain version, the one kernels D and E are
held to on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_style_transfer_ldm_tpu.losses import LPIPSLoss as JaxLPIPSLoss
from music_style_transfer_ldm_tpu.losses import (
    VGGishFeatureLoss as JaxVGGishLoss,
)
from music_style_transfer_ldm_tpu.losses import basic as jbasic
from music_style_transfer_ldm_tpu.losses.lpips import LPIPS as JaxLPIPS
from music_style_transfer_ldm_tpu.losses.vggish import (
    VGGishFeatures as JaxVGGish,
)
from music_style_transfer_ldm_tpu_torch.interop.flax_weights import (
    load_flax_convs,
)
from music_style_transfer_ldm_tpu_torch.losses import (
    LPIPSLoss, VGGishFeatureLoss, VGGishFeatures, gram_matrix,
    perceptual_loss,
)
from music_style_transfer_ldm_tpu_torch.losses import basic
from music_style_transfer_ldm_tpu_torch.ops import normalized_mse as nm

RTOL_LOSS = 1e-5       # f32 both sides; only summation order differs
# The JAX package's f32 VGGish distance at 128 x 128 is 5e-5 (relative)
# from its float64-statistics value, the port's 0 to 1e-7: the VGGish
# value is held to JAX at this bound and to the port's float64 oracle at
# RTOL_LOSS (the bars test_torch_distributed.py holds the LDM's losses
# to).
RTOL_JAX_VGGISH = 1e-4
GRAD_OF_MAX = 1e-4     # max abs error / max |grad|


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.lru_cache(maxsize=1)
def _inputs():
    rng = np.random.RandomState(42)
    return (rng.rand(2, 128, 128, 1).astype(np.float32),
            rng.rand(2, 128, 128, 1).astype(np.float32))


@functools.lru_cache(maxsize=1)
def _jax_losses():
    """The JAX losses with the parameters ``VGGishFeatureLoss(seed=0)``
    and ``LPIPSLoss(seed=0)`` initialise (the same init, under jit and on
    small inputs: a conv's parameters do not depend on the image size),
    and their value and input gradients at the inputs."""
    x, y = _inputs()
    key = jax.random.PRNGKey(0)
    small = jnp.zeros((1, 32, 32, 1), jnp.float32)
    out = {
        "vggish": JaxVGGishLoss(params=jax.jit(JaxVGGish().init)(
            key, small)["params"]),
        "lpips": JaxLPIPSLoss(params=jax.jit(JaxLPIPS().init)(
            key, small, small)["params"])}
    for name, loss in out.items():
        f = jax.jit(jax.value_and_grad(lambda a, b, loss=loss: loss(a, b),
                                       argnums=(0, 1)))
        v, (ga, gb) = f(x, y)
        out[name] = (loss, float(v), np.asarray(ga), np.asarray(gb))
    return out


def _port(name):
    """The port's loss on the CPU with the JAX loss's weights."""
    jloss = _jax_losses()[name][0]
    loss = (VGGishFeatureLoss if name == "vggish" else LPIPSLoss)(
        device="cpu")
    load_flax_convs(loss.module, jloss.params)
    return loss


def _t(x, grad=False):
    return torch.tensor(x, requires_grad=grad)


def _of_max(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ["vggish", "lpips"])
def test_loss_value_and_input_gradients_match_jax(name):
    _, v, ga, gb = _jax_losses()[name]
    x, y = _inputs()
    loss = _port(name)
    X, Y = _t(x, True), _t(y, True)
    got = loss(X, Y)
    got.backward()
    assert got.dtype == torch.float32 and got.ndim == 0
    rtol = RTOL_JAX_VGGISH if name == "vggish" else RTOL_LOSS
    np.testing.assert_allclose(got.item(), v, rtol=rtol)
    assert _of_max(X.grad.numpy(), ga) < GRAD_OF_MAX
    assert _of_max(Y.grad.numpy(), gb) < GRAD_OF_MAX
    assert all(p.grad is None and not p.requires_grad
               for p in loss.module.parameters())     # frozen
    with torch.no_grad():
        assert loss(X, X).item() < 1e-8
        assert loss(X[:1], Y[:1]).item() > 0.0


def test_vggish_value_matches_the_float64_oracle(monkeypatch):
    x, y = _inputs()
    loss = _port("vggish")
    with torch.no_grad():
        got = loss(_t(x), _t(y)).item()
        monkeypatch.setattr(nm, "STAT_DTYPE", torch.float64)
        oracle = loss(_t(x), _t(y)).item()
    np.testing.assert_allclose(got, oracle, rtol=RTOL_LOSS)


def test_loss_classes_take_state_dicts_and_seeds():
    """``params`` is a state dict of the module; without one the init is
    seeded; the JAX signature's input_shape changes nothing."""
    a = VGGishFeatureLoss(seed=3, device="cpu")
    b = VGGishFeatureLoss(params=a.module.state_dict(), seed=9,
                          input_shape=(4, 64, 64, 1), device="cpu")
    c = VGGishFeatureLoss(seed=3, device="cpu")
    for other in (b, c):
        for k, v in a.module.state_dict().items():
            torch.testing.assert_close(other.module.state_dict()[k], v,
                                       rtol=0, atol=0)
    assert isinstance(a.module, VGGishFeatures) and a.impl == "auto"
    if not torch.cuda.is_available():
        for cls in (VGGishFeatureLoss, LPIPSLoss):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls()


def test_perceptual_loss_dispatch_matches_jax(monkeypatch):
    monkeypatch.setattr(basic, "_DEFAULT_LPIPS", {})
    x, y = (_t(a) for a in _inputs())
    vgg = _port("vggish")
    with pytest.raises(ValueError, match="VGGish"):
        perceptual_loss(x, y, "vggish", None)
    want = vgg(x, y).item()
    assert perceptual_loss(x, y, "vggish", vgg).item() == want
    assert perceptual_loss(x, y, "lpips", vgg).item() == want
    # the default LPIPS: built once for the CPU from seed 0 and kept; with
    # the weights of JAX's default (its LPIPSLoss from PRNGKey(0),
    # losses/basic.py) it gives JAX's value
    first = perceptual_loss(x, y, "lpips")
    default = basic._DEFAULT_LPIPS[torch.device("cpu")]
    assert first.item() == LPIPSLoss(seed=0, device="cpu")(x, y).item()
    load_flax_convs(default.module, _jax_losses()["lpips"][0].params)
    got = perceptual_loss(x, y, "lpips")
    assert basic._DEFAULT_LPIPS == {torch.device("cpu"): default}
    np.testing.assert_allclose(got.item(), _jax_losses()["lpips"][1],
                               rtol=RTOL_LOSS)


def test_gram_matrix_matches_jax():
    f = np.random.RandomState(42).randn(2, 8, 8, 16).astype(np.float32)
    got = gram_matrix(_t(f))
    assert got.shape == (2, 16, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jbasic.gram_matrix(f)),
                               rtol=RTOL_LOSS, atol=1e-7)
    np.testing.assert_array_equal(got.numpy(),
                                  got.transpose(1, 2).numpy())
    half = gram_matrix(_t(f).bfloat16())
    assert half.dtype == torch.float32
