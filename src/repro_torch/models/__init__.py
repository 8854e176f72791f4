"""LM substrate of the port: configurable transformer families
(dense/MoE/SSM/hybrid/enc-dec/VLM) with stacked blocks, chunked attention,
SSD state-space layers and GShard MoE."""

from .config import ModelConfig, MoEConfig, SSMConfig, SHAPES, ShapeSpec  # noqa: F401
from .api import (  # noqa: F401
    abstract_params, build_loss_fn, build_prefill_fn, build_serve_step,
    input_specs, materialize_inputs,
)
from .transformer import init_model, train_loss, prefill, serve_step, \
    init_decode_caches  # noqa: F401
