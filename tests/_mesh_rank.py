"""One rank of ``tests/test_torch_mesh_spmd.py``'s (data, rays) mesh, on
the CPU over gloo:

    python tests/_mesh_rank.py <dir> <rank> <world>

Reads ``<dir>/inputs.pt`` (each case's config overrides and the converted
weights and inputs), joins the process group through ``file://<dir>/pg``,
runs every case with the port and writes ``<dir>/rank<rank>.pt``. Imports
nothing of JAX.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from papr_tpu_torch.config import load_config  # noqa: E402
from papr_tpu_torch.nn.mlp import policy_from_config  # noqa: E402
from papr_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from papr_tpu_torch.parallel.collectives import reduce_gradients  # noqa: E402
from papr_tpu_torch.train.optim import (build_group_specs,  # noqa: E402
                                        tree_leaves, tree_map)


def _plan(inp):
    return pmesh.make_plan(pmesh.make_mesh(*inp["mesh"]))


def attention(inp):
    """The ray-sharded attention, forward and the gradient of
    sum(fused^2) + sum(bkg attn^2) over the global batch."""
    from papr_tpu_torch.model.papr import _attend_spmd
    cfg = load_config(overrides=inp["over"])
    plan = _plan(inp)
    mesh = plan.mesh
    live = tree_map(lambda t: t.clone().requires_grad_(True), inp["params"])
    fused, attn, idx = _attend_spmd(
        live, inp["state"], cfg, plan.batch_block(inp["rayo"]),
        plan.ray_block(inp["rayd"]), policy_from_config(cfg), mesh)
    loss = (fused ** 2).sum() + (attn[..., -1] ** 2).sum()
    leaves = tree_leaves(live)
    # reduce_gradients takes the mean over data groups; this loss is a sum.
    grads = torch.autograd.grad(loss * mesh.data / mesh.rays, leaves,
                                allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    reduce_gradients(grads, mesh)
    return {"fused": fused.detach(), "attn": attn.detach(), "idx": idx,
            "grads": grads}


def step(inp):
    """The training step's loss and gradients, then one full step: the
    parameters after it."""
    from papr_tpu_torch.train.losses import get_loss
    from papr_tpu_torch.train.step import (dropout_generator, loss_and_grads,
                                           make_opt_state, make_train_step)
    cfg = load_config(overrides=inp["over"])
    plan = _plan(inp)
    loss_fn = get_loss(cfg.training.losses, lpips_params=inp.get("lpips"),
                       policy=policy_from_config(cfg))
    params, state = inp["params"], inp["state"]
    rayo, rayd = plan.batch_block(inp["rayo"]), plan.ray_block(inp["rayd"])
    target, c2w = plan.batch_block(inp["target"]), plan.batch_block(inp["c2w"])
    loss, pred, grads = loss_and_grads(
        params, state, cfg, rayo, rayd, target, c2w, loss_fn,
        build_group_specs(cfg), policy_from_config(cfg),
        dropout_rng=dropout_generator(cfg, 0, "cpu"), mesh=plan.mesh)
    step_fn = make_train_step(cfg, loss_fn, sharding=plan)
    params = tree_map(torch.clone, params)
    params, _, loss2, _ = step_fn(params, make_opt_state(cfg, params), state,
                                  rayo, rayd, target, c2w, 0)
    return {"loss": loss, "pred": pred, "grads": grads, "loss_step": loss2,
            "params": params}


def render(inp):
    """The tile-sharded renders: a frame of wrapped tiles and a one-tile
    serving frame."""
    from papr_tpu_torch.train.step import render_frame, render_full_image
    cfg = load_config(overrides=inp["over"])
    th, tw = inp["tiles"]
    out = render_full_image(inp["params"], inp["state"], cfg, inp["rayo"],
                            inp["rayd"], th, tw, with_depth=True)
    out["frame"] = render_frame(inp["params"], inp["state"], cfg, inp["c2w"],
                                *inp["frame"])
    return out


CASES = {"attention": attention, "step": step, "render": render}


def main() -> None:
    tmp, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    pmesh.init_ranks(f"file://{tmp}/pg", rank, world)
    inputs = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    out = {name: CASES[inp["case"]](inp) for name, inp in inputs.items()}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt.tmp"))
    os.replace(os.path.join(tmp, f"rank{rank}.pt.tmp"),
               os.path.join(tmp, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
