"""The port's LM path (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package on the CPU.

Inputs come from numpy seeds and weights are carried across with
``repro_torch.convert.model_from_numpy``, so both packages compute on the
same numbers (the smoke configs are float32). Tolerances: chunked attention,
the loss, prefill logits and decode logits at 1e-5 relative to the largest
reference value (float32 sums taken in another order); gradients at 1e-4
relative in max norm (the backward pass sums over the batch, the sequence
and the layers' repeats in another order again). Configs, shapes and the
parameter tree must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import supported_shapes as jsupported_shapes
from repro.models import abstract_params as jabstract_params
from repro.models import init_decode_caches as jinit_decode_caches
from repro.models import init_model as jinit_model
from repro.models import input_specs as jinput_specs
from repro.models import materialize_inputs as jmaterialize_inputs
from repro.models import prefill as jprefill
from repro.models import serve_step as jserve_step
from repro.models import train_loss as jtrain_loss
from repro.models import layers as JL
from repro_torch.configs import ARCHS, get_config, supported_shapes
from repro_torch.convert import model_from_numpy, model_to_numpy
from repro_torch.models import (abstract_params, init_decode_caches,
                                init_model, input_specs, materialize_inputs,
                                prefill, serve_step, train_loss)
from repro_torch.models import layers as L
from repro_torch.tree import flatten_with_path, leaves, path_str, unflatten

# jitted once per module (un-jitted, each call compiles its scans anew)
jserve_jit = jax.jit(jserve_step, static_argnums=4)
jdecode_jit = jax.jit(JL.decode_attention, static_argnums=2)
jprefill_jit = jax.jit(jprefill, static_argnums=2)
jloss_grad_jit = jax.jit(jax.value_and_grad(jtrain_loss), static_argnums=2)

DENSE = ["qwen1.5-0.5b", "mistral-nemo-12b", "stablelm-1.6b",
         "phi3-mini-3.8b"]
OTHER = ["jamba_v0_1_52b", "whisper_large_v3", "llama4_maverick_400b_a17b",
         "granite_moe_3b_a800m", "mamba2_130m", "llama_3_2_vision_90b"]


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


def jax_params(cfg_name: str):
    """(JAX config, port config, JAX params, port params on the CPU)."""
    jcfg = jget_config(cfg_name, smoke=True)
    cfg = get_config(cfg_name, smoke=True)
    jp = jinit_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, model_from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu")


# -- layers -----------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,H,KV,hd,qc,kc,q_offset", [
    (128, 4, 2, 16, 32, 32, 0),    # causal: the triangular schedule
    (96, 6, 6, 8, 32, 48, 0),      # the rectangle scan
    (64, 8, 2, 32, 64, 16, 0),
    (64, 4, 2, 16, 16, 16, 24),    # offset prefill: the rectangle
])
def test_chunked_attention_matches_jax(S, H, KV, hd, qc, kc, q_offset,
                                       causal):
    rng = np.random.default_rng(S + H + q_offset)
    B = 2
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, q_chunk=qc,
                                k_chunk=kc, q_offset=q_offset)
    got = L.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              q_chunk=qc, k_chunk=kc, q_offset=q_offset)
    assert got.shape == (B, S, H * hd)
    assert rel(got, want) <= 1e-5


def test_decode_attention_matches_prefix_and_jax():
    """Decoding token t against a cache == full attention at position t,
    and each step equals the JAX package's; so do the context K/V and
    one-token cross-attention."""
    jcfg, cfg = jget_config("qwen1_5_0_5b", smoke=True), \
        get_config("qwen1_5_0_5b", smoke=True)
    jp = JL.init_attention(jax.random.PRNGKey(1), jcfg, jnp.float32)
    p = model_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    B, S = 2, 16
    x = (np.random.default_rng(2).standard_normal((B, S, cfg.d_model))
         * 0.1).astype(np.float32)
    xt = torch.from_numpy(x)
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    full = L.attention_block(p, xt, cfg, pos, causal=True)
    shape = (B, S, cfg.num_kv_heads, cfg.hd)
    cache = L.KVCache(torch.zeros(shape), torch.zeros(shape))
    jcache = JL.KVCache(jnp.zeros(shape, jnp.float32),
                        jnp.zeros(shape, jnp.float32))
    outs = []
    for t in range(S):
        out, cache = L.decode_attention(p, xt[:, t:t + 1], cfg, cache, t)
        jout, jcache = jdecode_jit(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                   jcache, jnp.asarray(t, jnp.int32))
        assert rel(out, jout) <= 1e-5
        outs.append(out)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)
    assert rel(cache.k, jcache.k) <= 1e-6
    # the context K/V and one-token cross-attention against them
    ctx = np.random.default_rng(3).standard_normal((B, 8, cfg.d_model)) \
        .astype(np.float32)
    jkv = JL.cross_kv(jp, jnp.asarray(ctx), jcfg)
    kv = L.cross_kv(p, torch.from_numpy(ctx), cfg)
    assert max(rel(a, b) for a, b in zip(kv, jkv)) <= 1e-6
    got = L.decode_cross_attention(p, xt[:, :1], cfg, L.KVCache(*kv))
    want = JL.decode_cross_attention(jp, jnp.asarray(x[:, :1]), jcfg,
                                     JL.KVCache(*jkv))
    assert rel(got, want) <= 1e-5


def test_int8_kv_cache_matches_jax():
    """The int8 cache (static scale 16) decodes as the JAX package's, and
    stays close to the float cache."""
    jcfg, cfg, jp, p = jax_params("qwen1_5_0_5b")
    outs = {}
    for kvd in ("", "int8"):
        jc = dataclasses.replace(jcfg, kv_cache_dtype=kvd)
        c = dataclasses.replace(cfg, kv_cache_dtype=kvd)
        jcaches = jinit_decode_caches(jc, 2, 32)
        caches = init_decode_caches(c, 2, 32, device="cpu")
        tok = np.full((2, 1), 5, np.int32)
        for t in range(4):
            jlog, jcaches = jserve_jit(jp, jcaches, jnp.asarray(tok + t),
                                       jnp.asarray(t, jnp.int32), jc)
            log, caches = serve_step(p, caches, torch.from_numpy(tok + t), t,
                                     c)
        if kvd:
            assert caches[0].k.dtype == torch.int8
            np.testing.assert_array_equal(caches[0].k.numpy(),
                                          np.asarray(jcaches[0].k))
        else:
            assert rel(caches[0].k, jcaches[0].k) <= 1e-5
        assert rel(log, jlog) <= 1e-5
        outs[kvd] = log.numpy()
    ref, q8 = outs[""], outs["int8"]
    assert np.argmax(ref[0, 0]) == np.argmax(q8[0, 0])
    assert np.abs(ref - q8).max() / np.abs(ref).max() < 0.15


def test_embedding_tied_vs_untied():
    pt = init_model(0, get_config("qwen1_5_0_5b", smoke=True), device="cpu")
    pu = init_model(0, get_config("phi3_mini_3_8b", smoke=True),
                    device="cpu")
    assert "head" not in pt["emb"]
    assert "head" in pu["emb"]
    h = torch.randn(2, 3, 64)
    torch.testing.assert_close(L.unembed_logits(pt["emb"], h),
                               h @ pt["emb"]["tok"].T)
    torch.testing.assert_close(L.unembed_logits(pu["emb"], h),
                               h @ pu["emb"]["head"])


# -- whole model --------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_dense_model_matches_jax(arch):
    """train_loss (1e-5), its gradients (1e-4 in max norm), prefill logits
    and a 4-step serve_step (1e-5), all on JAX's weights."""
    jcfg, cfg, jp, p = jax_params(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    labs = rng.integers(-1, cfg.vocab_size, (2, 64)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)}
    jl, jg = jloss_grad_jit(jp, jbatch, jcfg)
    live = [x.clone().requires_grad_(True) for x in leaves(p)]
    loss = train_loss(unflatten(p, live), batch, cfg)
    grads = torch.autograd.grad(loss, live)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    jgl = jax.tree.leaves(jg)
    assert len(jgl) == len(grads)
    for g, jgrad in zip(grads, jgl):
        assert g.shape == jgrad.shape
        assert rel(g, jgrad) <= 1e-4

    logits = prefill(p, {"tokens": batch["tokens"]}, cfg)
    jlogits = jprefill_jit(jp, {"tokens": jbatch["tokens"]}, jcfg)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert rel(logits, jlogits) <= 1e-5

    caches = init_decode_caches(cfg, 2, 16, device="cpu")
    jcaches = jinit_decode_caches(jcfg, 2, 16)
    for t in range(4):
        log, caches = serve_step(p, caches, batch["tokens"][:, t:t + 1], t,
                                 cfg)
        jlog, jcaches = jserve_jit(jp, jcaches, jbatch["tokens"][:, t:t + 1],
                                   jnp.asarray(t, jnp.int32), jcfg)
        assert rel(log, jlog) <= 1e-5
    for c, jc in zip(leaves(caches), jax.tree.leaves(jcaches)):
        assert rel(c, jc) <= 1e-5


def test_remat_policies_change_no_value():
    """remat off, "full" and "dots" give one loss and one gradient."""
    cfg = get_config("qwen1_5_0_5b", smoke=True)
    p = init_model(0, cfg, device="cpu")
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (2, 32)))
             for k in ("tokens", "labels")}
    out = []
    for kw in ({"remat": False}, {"remat": True},
               {"remat": True, "remat_policy": "dots"}):
        live = [x.clone().requires_grad_(True) for x in leaves(p)]
        loss = train_loss(unflatten(p, live), batch,
                          dataclasses.replace(cfg, **kw))
        out.append((loss.detach(), torch.autograd.grad(loss, live)))
    for loss, grads in out[1:]:
        torch.testing.assert_close(loss, out[0][0], rtol=1e-6, atol=0)
        for g, g0 in zip(grads, out[0][1]):
            torch.testing.assert_close(g, g0, rtol=1e-5, atol=1e-7)


def test_parameter_tree_is_jax_s():
    """Names, shapes and order of every leaf, of every architecture;
    abstract_params allocates nothing."""
    for arch in ARCHS:
        cfg = get_config(arch)
        jtree = jabstract_params(jget_config(arch))
        tree = abstract_params(cfg)
        jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
        flat = flatten_with_path(tree)
        assert [path_str(p, "/") for p, _ in flat] == [
            "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in p) for p, _ in jflat]
        for (_, x), (_, jx) in zip(flat, jflat):
            assert x.device.type == "meta"
            assert tuple(x.shape) == jx.shape
            assert str(x.dtype).split(".")[1] == str(jx.dtype)
        assert sum(x.numel() for x in leaves(tree)) == cfg.param_count()


# -- configs, specs, inputs ---------------------------------------------------------


def test_configs_match_jax():
    assert ARCHS == JARCHS
    for arch in ARCHS:
        for smoke in (False, True):
            cfg, jcfg = get_config(arch, smoke=smoke), \
                jget_config(arch, smoke=smoke)
            assert cfg.param_count() == jcfg.param_count()
            assert cfg.active_param_count() == jcfg.active_param_count()
            assert cfg.layer_pattern() == jcfg.layer_pattern()
            assert supported_shapes(cfg) == jsupported_shapes(jcfg)
    assert get_config("qwen1.5-0.5b").tdtype == torch.bfloat16
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", DENSE + OTHER)
def test_input_specs_and_inputs_match_jax(arch):
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        specs, jspecs = input_specs(cfg, shape), jinput_specs(jcfg, shape)
        assert sorted(specs) == sorted(jspecs)
        for x, jx in zip(leaves(specs), jax.tree.leaves(jspecs)):
            assert tuple(x.shape) == jx.shape and x.device.type == "meta"
    for shape in ("train_4k", "prefill_32k"):
        got = materialize_inputs(cfg, shape, seed=1, device="cpu")
        want = jmaterialize_inputs(jcfg, shape, seed=1)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))


def test_convert_round_trip():
    _, _, jp, p = jax_params("stablelm-1.6b")
    back = model_to_numpy(p)
    for a, b in zip(leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    bf = dataclasses.replace(jget_config("phi3-mini-3.8b", smoke=True),
                             dtype="bfloat16")
    jb = jinit_model(jax.random.PRNGKey(1), bf)
    pb = model_from_numpy(jax.tree.map(np.asarray, jb), device="cpu")
    for a, b in zip(leaves(pb), jax.tree.leaves(jb)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
