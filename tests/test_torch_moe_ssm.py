"""The port's MoE and SSD layers (``repro_torch.models.moe`` / ``.ssm``)
against the JAX package's on the CPU, on JAX's weights carried across with
``repro_torch.convert.model_from_numpy``; mirrors
tests/test_model_units.py's SSD and MoE tests.

Tolerances: outputs at 1e-5 relative to the largest reference value
(float32 sums taken in another order); the port's SSD against its own
decode recurrence at the JAX test's 2e-4; the top-k indices equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMOE
from repro.models import ssm as JSSM
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.config import SSMConfig as JSSMConfig
from repro_torch.convert import model_from_numpy
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small torch ops a call: one intra-op thread beside the suite's
    other workers. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def both(make_cfg, **kw):
    """The same config in both packages."""
    return make_cfg(JModelConfig, JSSMConfig, JMoEConfig, **kw), \
        make_cfg(ModelConfig, SSMConfig, MoEConfig, **kw)


# -- SSD ----------------------------------------------------------------------------


def ssm_cfg(MC, SC, _, chunk=8):
    return MC(name="ssd-test", family="ssm", num_layers=1, d_model=32,
              num_heads=2, num_kv_heads=2, d_ff=0, vocab_size=64,
              ssm=SC(d_state=8, expand=2, head_dim=8, conv_width=4,
                     chunk=chunk),
              dtype="float32", remat=False)


def ssm_weights(jcfg):
    jp = JSSM.init_ssm(jax.random.PRNGKey(0), jcfg, jnp.float32)
    # non-trivial dt_bias / D_skip / conv_b, so that each term is held
    rng = np.random.default_rng(5)
    jp = dict(jp, dt_bias=jnp.asarray(rng.standard_normal(jp["dt_bias"].shape)
                                      * 0.5, jnp.float32),
              conv_b=jnp.asarray(rng.standard_normal(jp["conv_b"].shape)
                                 * 0.1, jnp.float32))
    return jp, model_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def test_ssd_forward_matches_jax_and_its_recurrence():
    """ssd_forward against JAX's (1e-5); against the port's own decode
    recurrence token by token (2e-4), whose states match JAX's (1e-5)."""
    jcfg, cfg = both(ssm_cfg)
    jp, p = ssm_weights(jcfg)
    B, Ln = 2, 32
    x = (np.random.default_rng(1).standard_normal((B, Ln, cfg.d_model))
         * 0.5).astype(np.float32)
    want = JSSM.ssd_forward(jp, jnp.asarray(x), jcfg)
    got = SSM.ssd_forward(p, torch.from_numpy(x), cfg)
    assert got.shape == (B, Ln, cfg.d_model)
    assert rel(got, want) <= 1e-5

    state = SSM.ssm_init_state(cfg, B, torch.float32)
    jstate = JSSM.ssm_init_state(jcfg, B, jnp.float32)
    step = jax.jit(JSSM.ssd_decode_step, static_argnums=2)
    outs = []
    for t in range(Ln):
        out, state = SSM.ssd_decode_step(p, torch.from_numpy(x[:, t:t + 1]),
                                         cfg, state)
        jout, jstate = step(jp, jnp.asarray(x[:, t:t + 1]), jcfg, jstate)
        assert rel(out, jout) <= 1e-5
        outs.append(out)
    assert rel(state.ssm, jstate.ssm) <= 1e-5
    assert rel(state.conv, jstate.conv) <= 1e-6
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), got.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_ssd_chunk_invariance_and_causality():
    """Chunk 8 against chunk 16 (1e-5); future tokens leave past outputs
    as they were; the gradient through the -inf mask is finite."""
    jcfg8, cfg8 = both(ssm_cfg)
    _, cfg16 = both(ssm_cfg, chunk=16)
    _, p = ssm_weights(jcfg8)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, cfg8.d_model)).astype(np.float32))
    y8 = SSM.ssd_forward(p, x, cfg8)
    y16 = SSM.ssd_forward(p, x, cfg16)
    assert rel(y8, y16) <= 1e-5
    x2 = x.clone()
    x2[:, 20:] = 0.0
    y2 = SSM.ssd_forward(p, x2, cfg8)
    np.testing.assert_allclose(y2[:, :20].numpy(), y8[:, :20].numpy(),
                               rtol=1e-5, atol=1e-6)
    live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xg = x.clone().requires_grad_(True)
    SSM.ssd_forward(live, xg, cfg8).square().sum().backward()
    for g in [xg.grad] + [v.grad for v in live.values()]:
        assert g is not None and torch.isfinite(g).all()


def test_ssd_gradients_match_jax():
    """The chunk loop rematerialized (torch.utils.checkpoint) gives JAX's
    gradients (1e-4 in max norm)."""
    jcfg, cfg = both(ssm_cfg)
    jp, p = ssm_weights(jcfg)
    x = (np.random.default_rng(3).standard_normal((2, 32, cfg.d_model))
         * 0.5).astype(np.float32)
    jg = jax.grad(lambda q, xx: jnp.sum(JSSM.ssd_forward(q, xx, jcfg) ** 2),
                  argnums=(0, 1))(jp, jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    SSM.ssd_forward(live, xt, cfg).square().sum().backward()
    assert rel(xt.grad, jg[1]) <= 1e-4
    for k in p:
        assert rel(live[k].grad, jg[0][k]) <= 1e-4, k


# -- MoE ----------------------------------------------------------------------------


def moe_cfg(MC, _, EC, top_k=2, experts=4, cf=10.0, act="swiglu",
            shared=False):
    return MC(name="moe-test", family="moe", num_layers=1, d_model=16,
              num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=64, act=act,
              moe=EC(num_experts=experts, top_k=top_k, d_ff_expert=32,
                     group_size=32, capacity_factor=cf,
                     shared_expert=shared),
              dtype="float32", remat=False)


def moe_case(**kw):
    jcfg, cfg = both(moe_cfg, **kw)
    jp = JMOE.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    p = model_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 32, 16),
                                    jnp.float32))
    return jcfg, cfg, jp, p, x


@pytest.mark.parametrize("kw", [
    {"cf": 10.0}, {"cf": 0.1},                      # no drops, drops
    {"cf": 1.0, "top_k": 3, "experts": 5},          # granite-like
    {"cf": 1.25, "top_k": 1, "experts": 8, "shared": True},   # llama4-like
    {"cf": 1.0, "act": "gelu"},
])
def test_moe_matches_jax(kw):
    """apply_moe and its auxiliary loss at 1e-5, with and without capacity
    drops; the router's top-k indices equal JAX's."""
    jcfg, cfg, jp, p, x = moe_case(**kw)
    jy, jaux = JMOE.apply_moe(jp, jnp.asarray(x), jcfg)
    y, aux = MOE.apply_moe(p, torch.from_numpy(x), cfg)
    assert rel(y, jy) <= 1e-5
    assert abs(float(aux) - float(jaux)) <= 1e-5 * abs(float(jaux))
    jprobs = jax.nn.softmax((jnp.asarray(x).reshape(2, 32, 16) @ jp["router"])
                            .astype(jnp.float32), axis=-1)
    _, jidx = jax.lax.top_k(jprobs, cfg.moe.top_k)
    _, _, idx, _, pos, C = MOE._route(p, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    drops = int((pos >= C).sum())
    if kw["cf"] >= 10.0:
        assert drops == 0
    if kw["cf"] <= 0.1:
        assert drops > 0


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router probabilities: the lower expert first, as
    jax.lax.top_k."""
    probs = torch.tensor([[[0.25, 0.25, 0.25, 0.25],
                           [0.1, 0.4, 0.1, 0.4]]])
    _, idx = MOE._top_k(probs, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.tolist() == [[[0, 1], [1, 3]]]


def test_moe_matches_dense_routing_oracle():
    """With huge capacity (no drops), GShard dispatch == direct top-k."""
    _, cfg, _, p, x = moe_case()
    y, aux = MOE.apply_moe(p, torch.from_numpy(x), cfg)
    xd = torch.from_numpy(x).double()
    probs = torch.softmax(xd @ p["router"].double(), -1)
    gv, gi = MOE._top_k(probs, cfg.moe.top_k)
    gv = gv / gv.sum(-1, keepdim=True)
    want = torch.zeros_like(xd)
    for kk in range(cfg.moe.top_k):
        e = gi[..., kk]
        hg = torch.einsum("btd,btdf->btf", xd, p["wg"].double()[e])
        hu = torch.einsum("btd,btdf->btf", xd, p["wu"].double()[e])
        out = torch.einsum("btf,btfd->btd", torch.nn.functional.silu(hg) * hu,
                           p["wd"].double()[e])
        want += gv[..., kk:kk + 1] * out
    assert rel(y.double(), want.numpy()) <= 2e-5
    assert float(aux) > 0


def test_moe_capacity_drops_tokens():
    """A tiny capacity factor drops tokens (the output shrinks), and a
    dropped slot dispatches nowhere."""
    _, cfg_big, _, p, x = moe_case(cf=10.0)
    cfg_small = dataclasses.replace(
        cfg_big, moe=dataclasses.replace(cfg_big.moe, capacity_factor=0.1))
    xt = torch.from_numpy(x)
    y_big, _ = MOE.apply_moe(p, xt, cfg_big)
    y_small, _ = MOE.apply_moe(p, xt, cfg_small)
    assert torch.linalg.norm(y_small) < torch.linalg.norm(y_big)
    drops = {}
    for name, cfg in (("big", cfg_big), ("small", cfg_small)):
        *_, pos, C = MOE._route(p, xt, cfg)
        drops[name] = int((pos >= C).sum())
    assert drops["big"] == 0
    # capacity 4 in each of 2 groups of 32 tokens x 2 slots over 4
    # experts: at most 2 x 16 kept
    assert drops["small"] >= 2 * 2 * 32 - 2 * 16
