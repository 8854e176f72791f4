"""LM substrate of the port: the dense transformer family with stacked
blocks, chunked attention and chunked cross-entropy (MoE, SSM, hybrid,
audio and VLM families are ROADMAP Queue 1 item 10)."""

from .config import ModelConfig, MoEConfig, SSMConfig, SHAPES, ShapeSpec  # noqa: F401
from .api import (  # noqa: F401
    abstract_params, build_loss_fn, build_prefill_fn, build_serve_step,
    input_specs, materialize_inputs,
)
from .transformer import init_model, train_loss, prefill, serve_step, \
    init_decode_caches  # noqa: F401
