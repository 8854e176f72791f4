"""The MoE, SSM, hybrid, audio and VLM families of the port against the JAX
package on the CPU, whole models at smoke size (float32), on JAX's weights
carried across with ``repro_torch.convert.model_from_numpy``.

Tolerances as tests/test_torch_models.py's dense case: the loss, prefill
logits, decode logits and every cache leaf at 1e-5 relative to the largest
reference value; gradients at 1e-4 relative in max norm. A decode step fed
the prompt token by token is held against ``prefill`` at 1e-4 (the two sum
over the sequence in another order), in both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.models import init_decode_caches as jinit_decode_caches
from repro.models import init_model as jinit_model
from repro.models import layers as JL
from repro.models import prefill as jprefill
from repro.models import serve_step as jserve_step
from repro.models import train_loss as jtrain_loss
from repro.models import transformer as JT
from repro.models.api import _enc_len as j_enc_len
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import model_from_numpy
from repro_torch.models import (abstract_params, init_decode_caches,
                                init_model, prefill, serve_step, train_loss)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import _enc_len
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import flatten_with_path, leaves, path_str, unflatten

jserve_jit = jax.jit(jserve_step, static_argnums=4)
jprefill_jit = jax.jit(jprefill, static_argnums=2)
jloss_grad_jit = jax.jit(jax.value_and_grad(jtrain_loss), static_argnums=2)

FAMILIES = ["jamba_v0_1_52b", "whisper_large_v3",
            "llama4_maverick_400b_a17b", "granite_moe_3b_a800m",
            "mamba2_130m", "llama_3_2_vision_90b"]
B, S = 2, 64


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small torch ops a call: one intra-op thread beside the suite's
    other workers. Restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def jax_params(arch: str, **replace):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **replace)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **replace)
    jp = jinit_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, model_from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu")


def batch_np(cfg, seed: int = 3) -> dict:
    """tokens, labels (-1 ignored) and the family's frames / patches."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(-1, cfg.vocab_size, (B, S))
           .astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, _enc_len(cfg, S), cfg.d_model)).astype(np.float32)
    elif cfg.frontend_tokens:
        out["patches"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


# -- whole model --------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_matches_jax(arch):
    """train_loss with the MoE auxiliary loss (1e-5), its gradients (1e-4
    in max norm), prefill logits and 4 serve_steps (1e-5), then every
    cache leaf (1e-5), all on JAX's weights."""
    jcfg, cfg, jp, p = jax_params(arch)
    nb = batch_np(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    jl, jg = jloss_grad_jit(jp, jbatch, jcfg)
    live = [x.clone().requires_grad_(True) for x in leaves(p)]
    loss = train_loss(unflatten(p, live), batch, cfg)
    grads = torch.autograd.grad(loss, live)
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    jgl = jax.tree.leaves(jg)
    assert len(jgl) == len(grads)
    for g, jgrad in zip(grads, jgl):
        assert g.shape == jgrad.shape and g.dtype == live[0].dtype
        assert rel(g, jgrad) <= 1e-4
    if cfg.moe is not None:     # the auxiliary loss is in the loss
        h = L.embed(p["emb"], batch["tokens"])
        _, aux = T.apply_blocks(p, h, cfg, ctx=T._context(p, batch, cfg))
        _, jaux = JT.apply_blocks(jp, JL.embed(jp["emb"], jbatch["tokens"]),
                                  jcfg, ctx=None)
        assert float(aux) > 0
        assert abs(float(aux) - float(jaux)) <= 1e-5 * float(jaux)

    inputs = {k: v for k, v in batch.items() if k != "labels"}
    jinputs = {k: v for k, v in jbatch.items() if k != "labels"}
    logits = prefill(p, inputs, cfg)
    jlogits = jprefill_jit(jp, jinputs, jcfg)
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert rel(logits, jlogits) <= 1e-5

    caches = init_decode_caches(cfg, B, 16, ctx_len=_enc_len(cfg, 16),
                                device="cpu")
    jcaches = jinit_decode_caches(jcfg, B, 16, ctx_len=j_enc_len(jcfg, 16))
    for t in range(4):
        log, caches = serve_step(p, caches, batch["tokens"][:, t:t + 1], t,
                                 cfg)
        jlog, jcaches = jserve_jit(jp, jcaches, jbatch["tokens"][:, t:t + 1],
                                   jnp.asarray(t, jnp.int32), jcfg)
        assert rel(log, jlog) <= 1e-5
    flat, jflat = leaves(caches), jax.tree.leaves(jcaches)
    assert len(flat) == len(jflat)
    for c, jc in zip(flat, jflat):
        assert tuple(c.shape) == jc.shape
        assert str(c.dtype).split(".")[1] == str(jc.dtype)
        if np.abs(np.asarray(jc)).max() > 0:
            assert rel(c, jc) <= 1e-5
        else:       # the cross caches, zero as JAX's server leaves them
            assert not c.any()


@pytest.mark.parametrize("arch", ["whisper_large_v3",
                                  "llama_3_2_vision_90b"])
def test_decode_matches_prefill_with_context(arch):
    """With the cross caches filled from ``cross_kv`` of the encoder output
    (audio) or the patches (VLM), the decode step fed a prompt token by
    token ends on prefill's logits (1e-4), in both packages, and the port's
    equal JAX's (1e-5)."""
    jcfg, cfg, jp, p = jax_params(arch)
    nb = batch_np(cfg, seed=4)
    prompt = nb["tokens"][:1, :8]
    ctx = nb.get("frames", nb.get("patches"))[:1]
    pat, R = cfg.layer_pattern(), cfg.num_pattern_repeats
    # the context's K/V per (cache index, repeat, parameter path)
    if cfg.encoder_layers:
        jctx = JT.apply_encoder(jp, jnp.asarray(ctx), jcfg)
        tctx = T.apply_encoder(p, torch.from_numpy(ctx), cfg)
        where = [(len(pat) + i, i, "cross") for i in range(len(pat))]
        key = "frames"
    else:
        jctx, tctx = jnp.asarray(ctx), torch.from_numpy(ctx)
        where = [(i, i, "mixer") for i, (m, _) in enumerate(pat)
                 if m == "cross"]
        key = "patches"
    assert rel(tctx, jctx) <= 1e-5
    caches = init_decode_caches(cfg, 1, 16, ctx_len=ctx.shape[1],
                                device="cpu")
    jcaches = list(jinit_decode_caches(jcfg, 1, 16, ctx_len=ctx.shape[1]))
    for c, i, name in where:
        for r in range(R):
            bp = jax.tree.map(lambda x: x[r], jp["blocks"][i][name])
            k, v = JL.cross_kv(bp, jctx, jcfg)
            jcaches[c] = jcaches[c]._replace(k=jcaches[c].k.at[r].set(k),
                                             v=jcaches[c].v.at[r].set(v))
            tk, tv = L.cross_kv({n: x[r] for n, x in
                                 p["blocks"][i][name].items()}, tctx, cfg)
            caches[c].k[r], caches[c].v[r] = tk, tv
    jcaches = tuple(jcaches)
    for t in range(prompt.shape[1]):
        log, caches = serve_step(p, caches, torch.from_numpy(
            prompt[:, t:t + 1]), t, cfg)
        jlog, jcaches = jserve_jit(jp, jcaches, jnp.asarray(
            prompt[:, t:t + 1]), jnp.asarray(t, jnp.int32), jcfg)
        assert rel(log, jlog) <= 1e-5
    want = prefill(p, {"tokens": torch.from_numpy(prompt),
                       key: torch.from_numpy(ctx)}, cfg)
    jwant = jprefill_jit(jp, {"tokens": jnp.asarray(prompt),
                              key: jnp.asarray(ctx)}, jcfg)
    assert rel(log, want.numpy()) <= 1e-4
    assert rel(np.asarray(jlog), jwant) <= 1e-4


# -- parameter trees ----------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_tree(arch):
    """cfg.param_count() is the number of parameters the tree holds, at
    smoke size and (on the meta device) at full size."""
    assert ARCHS == JARCHS
    for smoke in (True, False):
        cfg = get_config(arch, smoke=smoke)
        tree = init_model(0, cfg, device="cpu") if smoke else \
            abstract_params(cfg)
        assert sum(x.numel() for x in leaves(tree)) == cfg.param_count()


def test_new_trees_cross_both_ways_in_bfloat16(tmp_path):
    """The expert leaves (R, E, D, F), the shared expert, the encoder and
    the float32 SSM leaves of bfloat16 models: JAX's names, shapes and
    dtypes through model_from_numpy, each leaf's dtype kept by AdamW and
    by a checkpoint's round trip."""
    for arch in ("jamba_v0_1_52b", "whisper_large_v3",
                 "llama4_maverick_400b_a17b"):
        jcfg, cfg, jp, p = jax_params(arch, dtype="bfloat16")
        jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
        flat = flatten_with_path(p)
        assert [path_str(q, "/") for q, _ in flat] == [
            "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in q)
            for q, _ in jflat]
        for (_, x), (_, jx) in zip(flat, jflat):
            assert str(x.dtype).split(".")[1] == str(jx.dtype)
            np.testing.assert_array_equal(x.float().numpy(),
                                          np.asarray(jx, np.float32))
        names = {path_str(q, "/"): x for q, x in flat}
        if cfg.ssm is not None:
            assert names["blocks/0/mixer/A_log"].dtype == torch.float32
            assert names["blocks/0/mixer/w_in"].dtype == torch.bfloat16
        if cfg.moe is not None:
            m = cfg.moe
            key = next(k for k in names if k.endswith("mlp/wg") and
                       names[k].ndim == 4)
            assert tuple(names[key].shape) == (
                cfg.num_pattern_repeats, m.num_experts, cfg.d_model,
                m.d_ff_expert)
            assert any("/shared/" in k for k in names) == m.shared_expert
        if cfg.encoder_layers:
            assert names["encoder/blocks/mixer/wq"].shape[0] == \
                cfg.encoder_layers
        ost = adamw_init(p, AdamWConfig())
        grads = [torch.ones_like(x) for x in leaves(p)]
        newp, ost = adamw_update(unflatten(p, grads), ost, p, AdamWConfig())
        assert [x.dtype for x in leaves(newp)] == [x.dtype for x in leaves(p)]
        path = save_checkpoint(tmp_path / arch, 1, (newp, ost))
        _, (back, _), _ = restore_checkpoint(path, (p, ost), device="cpu")
        for a, b in zip(leaves(back), leaves(newp)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_stacked_draws_equal_layer_by_layer_draws():
    """init_model draws each stacked leaf in place, with the values of
    drawing every layer's tree in turn and stacking them (a MoE, an SSM and
    an encoder-decoder model)."""
    for arch in ("granite_moe_3b_a800m", "jamba_v0_1_52b",
                 "whisper_large_v3"):
        cfg = get_config(arch, smoke=True)
        got = init_model(0, cfg, device="cpu")
        gen = torch.Generator().manual_seed(0)
        dt, R = cfg.tdtype, cfg.num_pattern_repeats

        def stack(trees):
            return {k: stack([t[k] for t in trees])
                    if isinstance(trees[0][k], dict)
                    else torch.stack([t[k] for t in trees])
                    for k in trees[0]}

        want = {"emb": L.init_embeddings(gen, cfg, dt, "cpu"),
                "blocks": [stack([T._init_block(gen, cfg, m, mlp, dt, "cpu")
                                  for _ in range(R)])
                           for m, mlp in cfg.layer_pattern()],
                "final_norm": L.init_norm(cfg, dt, "cpu")}
        if cfg.encoder_layers:
            want["encoder"] = {
                "blocks": stack([T._init_encoder_block(gen, cfg, dt, "cpu")
                                 for _ in range(cfg.encoder_layers)]),
                "final_norm": L.init_norm(cfg, dt, "cpu")}
        assert [path_str(q, "/") for q, _ in flatten_with_path(got)] == \
            [path_str(q, "/") for q, _ in flatten_with_path(want)]
        for a, b in zip(leaves(got), leaves(want)):
            assert torch.equal(a, b)


def test_adamw_updates_a_large_leaf_in_slices_bitwise(monkeypatch):
    """A leaf above adamw._CHUNK elements is updated slice by slice with
    the bits of the whole-leaf update (bfloat16 parameters, float32
    moments)."""
    from repro_torch.optim import adamw
    g = torch.Generator().manual_seed(2)
    p = {"big": torch.randn((3, 50, 7), generator=g).bfloat16(),
         "small": torch.randn((5,), generator=g)}
    grads = {k: torch.randn(v.shape, generator=g).to(v.dtype)
             for k, v in p.items()}
    cfg = AdamWConfig()
    state = adamw_init(p, cfg)
    p1, state = adamw_update(grads, state, p, cfg)
    whole = adamw_update(grads, state, p1, cfg)
    monkeypatch.setattr(adamw, "_CHUNK", 64)
    sliced = adamw_update(grads, state, p1, cfg)
    for a, b in zip(leaves(whole), leaves(sliced)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mamba2_130m", "whisper_large_v3"])
def test_server_slot_reset_clears_every_cache_leaf(arch):
    """DecodeServer's slot reset zeroes that slot of every cache leaf: the
    SSM states, the self KV caches and the cross caches; other slots keep
    theirs."""
    from repro_torch.train import DecodeServer
    cfg = get_config(arch, smoke=True)
    srv = DecodeServer(cfg, init_model(0, cfg, device="cpu"), slots=3,
                       max_len=32, device="cpu")
    for c in leaves(srv.caches):
        c.fill_(1)
    srv._reset_slot_cache(1)
    kinds = {type(c).__name__ for c in srv.caches}
    assert kinds == ({"SSMState"} if cfg.ssm else {"KVCache"})
    for c in leaves(srv.caches):
        assert c.shape[1] == 3
        assert not c[:, 1].any() and bool((c[:, 0] == 1).all()) and \
            bool((c[:, 2] == 1).all())
