"""One rank of ``tests/test_torch_sharding.py``'s sharded execution: the
smoke configs of qwen1.5 and granite-moe on a (2, 2) ``("data", "model")``
mesh of gloo CPU ranks, run by the port with its parameters placed by
``params_shardings`` and the activation hook installed.

    python tests/torch_model_ranks.py RANK WORLD STORE IN OUT

``STORE`` is the ``file://`` rendezvous of the process group, ``IN`` a
pickle the parent wrote (per arch: the JAX package's initial weights as
numpy arrays, a training batch, decode caches, a token and the cache
length), ``OUT`` the pickle this rank writes: per arch the loss, the
updated parameters and AdamW moments of one training step, and the
logits of one decode tick, each whole (``full_tensor``) as numpy arrays.
Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.convert import model_from_numpy
from repro_torch.launch.dryrun import sharded_decode_tick, sharded_train_step
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.tree import leaves, tree_map


def whole(tree):
    return tree_map(lambda x: x.full_tensor().numpy()
                    if hasattr(x, "full_tensor") else x.numpy(), tree)


def run(inputs: dict, mesh) -> dict:
    out = {}
    for arch, inp in inputs.items():
        cfg = get_config(arch, smoke=True)
        params = model_from_numpy(inp["params"], "cpu")
        batch = {k: torch.as_tensor(v) for k, v in inp["batch"].items()}
        loss, new_params, new_state = sharded_train_step(cfg, params, batch,
                                                         mesh)
        caches = tree_map(torch.as_tensor, inp["caches"])
        logits = sharded_decode_tick(cfg, params, caches,
                                     torch.as_tensor(inp["token"]),
                                     inp["cache_len"], mesh)
        out[arch] = {"loss": float(loss.full_tensor()),
                     "params": whole(new_params),
                     "m": whole(new_state.m), "v": whole(new_state.v),
                     "logits": whole(logits),
                     "param_bytes": sum(
                         x.to_local().numel() * x.to_local().element_size()
                         for x in leaves(new_params))}
    return out


def main(rank: int, world: int, store: str, in_path: str,
         out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
        with open(in_path, "rb") as fh:
            inputs = pickle.load(fh)
        out = run(inputs, mesh)
        with open(out_path, "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
