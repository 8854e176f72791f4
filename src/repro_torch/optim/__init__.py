"""Optimizers of the port: AdamW, TLR-Newton (the paper's factorization as
a training feature), ARA low-rank gradient compression."""

from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, \
    global_norm  # noqa: F401
from .grad_compress import (CompressConfig, CompressState, compress_grads,
                            compress_init)  # noqa: F401
from .tlr_newton import (TLRNewtonConfig, TLRNewtonState, tlr_newton_init,
                         tlr_newton_update)  # noqa: F401
