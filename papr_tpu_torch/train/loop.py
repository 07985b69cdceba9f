"""Training loop (``papr_tpu/train/loop.py``): the reference train.py loop.

Structure mirrors reference train.py:182-299 (prune/grow scheduling, eval
cadence, checkpointing, plots), as the JAX package re-orchestrated it:

  * the device-hot path is one eager step (``train/step.py``; bf16 under
    ``use_amp``, no GradScaler); the loss accumulates on the device and the
    host waits for the card only at the 200-step print and at the eval
    boundary;
  * prune/grow are host events on the padded cloud that reset optimizer
    moments (= the reference's optimizer rebuild);
  * resume restores optimizer moments and step counts too (the reference
    drops them).

Runs on the card unless ``PAPR_PLATFORM=cpu`` asks for the CPU
(``papr_tpu_torch/device.py``). A ``tpu.mesh`` of more than one device runs
one rank per device, launched by ``torchrun`` (``parallel/mesh.py``): batch
images over ``data``, patch rows over ``rays``, parameters replicated and
re-broadcast from rank 0 after every host event; rank 0 alone prints and
writes. In one process such a mesh raises ``ValueError``.
"""

from __future__ import annotations

import bisect
import os
import time

import numpy as np
import torch

from ..dataset import get_dataset, get_loader
from ..dataset.dataset import device_prefetch
from ..device import platform_device
from ..model.papr import create_model
from ..nn.activations import build_activation
from ..nn.mlp import policy_from_config
from ..parallel import mesh as pmesh
from ..parallel.collectives import barrier, replicate
from ..utils import plots
from .checkpoint import (import_torch, is_native, load_checkpoint,
                         load_histories, restore_into, save_checkpoint)
from .losses import build_loss, psnr
from .optim import build_group_specs, current_lrs, init_opt_state
from .points_host import add_points, prune_points
from .step import make_train_step, render_full_image


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _durable_dump(step, cfg, histories, state, eval_loss, eval_psnr, rgb):
    """Persist small run-evidence artifacts into a git-trackable directory.

    With ``tpu.durable_dir`` set, every eval rewrites committable
    artifacts: an append-only evals JSON (step / loss / psnr /
    alive-point-count), the full scalar histories, an eval-PSNR curve PNG,
    and the latest eval render, so a run can be plotted from the repo alone
    (reference analogue: the persisted loss-history tensors,
    train.py:148-150).
    """
    ddir = cfg.get_path("tpu.durable_dir", None)
    if not ddir:
        return
    import json

    os.makedirs(ddir, exist_ok=True)
    record = {"step": int(step), "train_loss": float(histories["train_losses"][-1]),
              "eval_loss": float(eval_loss), "eval_psnr": float(eval_psnr),
              "alive_points": int(state["alive"].sum().item())}
    path = os.path.join(ddir, "evals.json")
    evals = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                evals = json.load(f)
        except (json.JSONDecodeError, OSError):
            evals = []
    # a resume from an earlier snapshot re-runs later steps: drop stale tail
    evals = [e for e in evals if e["step"] < record["step"]]
    evals.append(record)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(evals, f, indent=1)
    os.replace(tmp, path)

    with open(os.path.join(ddir, "histories.json"), "w") as f:
        json.dump({k: [float(x) for x in v] for k, v in histories.items()}, f)

    plt = plots._plt()
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.4))
    xs = [e["step"] for e in evals]
    axes[0].plot(xs, [e["eval_psnr"] for e in evals], marker=".")
    axes[0].set_title("eval PSNR"); axes[0].set_xlabel("step")
    axes[1].semilogy(xs, [e["eval_loss"] for e in evals], marker=".",
                     label="eval")
    axes[1].semilogy(xs, [e["train_loss"] for e in evals], marker=".",
                     label="train")
    axes[1].legend(); axes[1].set_title("loss"); axes[1].set_xlabel("step")
    axes[2].plot(xs, [e["alive_points"] for e in evals], marker=".")
    axes[2].set_title("alive points"); axes[2].set_xlabel("step")
    fig.suptitle(f"{cfg.index} @ step {step}")
    fig.tight_layout()
    fig.savefig(os.path.join(ddir, "eval_curve.png"), dpi=110)
    plt.close(fig)

    from PIL import Image
    Image.fromarray((np.clip(rgb[0], 0, 1) * 255).astype(np.uint8)).save(
        os.path.join(ddir, "eval_latest.png"))


def eval_step(step, params, state, cfg, dataset, eval_dataset, batch,
              loss_fn, train_pred, histories, log_dir, eval_shading_code=None,
              write: bool = True):
    """Render the eval view, log metrics, save plots + checkpoint.

    Reference: train.py:29-152. ``eval_shading_code`` drives the FiLM path
    during exposure finetuning (the reference's eval renders unmodulated,
    which crashes for affine_layer >= 0 — here the eval image's code is used).
    Every rank of a mesh renders its tiles and computes the same metrics;
    only the one with ``write`` writes files.
    """
    gamma = beta = None
    if eval_shading_code is not None:
        from ..model.papr import mapping_apply
        gamma, beta = mapping_apply(params, cfg, eval_shading_code)
    img, rayd, rayo = eval_dataset.get_full_img(int(cfg.eval.img_idx))
    out = render_full_image(params, state, cfg, rayo, rayd,
                            int(cfg.eval.max_height), int(cfg.eval.max_width),
                            with_depth=True, gamma=gamma, beta=beta)
    rgb = np.clip(out["rgb"], 0, 1)
    dev = params["points"].device
    with torch.no_grad():
        rgb_t = torch.as_tensor(rgb, device=dev)
        img_t = torch.as_tensor(np.asarray(img, np.float32), device=dev)
        eval_loss = float(loss_fn(rgb_t, img_t))
        eval_psnr = float(psnr(rgb_t, img_t))
    histories["eval_losses"].append(eval_loss)
    histories["eval_psnrs"].append(eval_psnr)

    print(f"Eval step: {step} train_loss: {histories['train_losses'][-1]:.6f} "
          f"eval_loss: {eval_loss:.6f} eval_psnr: {eval_psnr:.4f}")

    if not write:
        return
    _durable_dump(step, cfg, histories, state, eval_loss, eval_psnr, rgb)

    if cfg.eval.save_fig and plots.available():
        os.makedirs(os.path.join(log_dir, "train_main_plots"), exist_ok=True)
        os.makedirs(os.path.join(log_dir, "train_pcd_plots"), exist_ok=True)
        coord_scale = cfg.dataset.coord_scale
        pt_plot_scale = 1.0 * coord_scale
        if "Barn" in cfg.dataset.path:
            pt_plot_scale *= 1.8
        if "Family" in cfg.dataset.path:
            pt_plot_scale *= 0.5

        alive = _host(state["alive"])
        points_np = _host(params["points"])[alive]
        influ_np = _host(params["points_influ_scores"])[alive, 0]
        train_img, train_rayd, train_rayo = dataset.get_full_img(
            int(batch.img_idx[0]))

        main = plots.training_main_plot(
            cfg.index, histories["steps"], train_img[0],
            _host(batch.image[0]),
            np.clip(train_pred[0], 0, 1), img[0], rgb[0],
            histories["train_losses"], histories["eval_losses"], points_np,
            pt_plot_scale, out["depth"][0], histories["pt_lrs"],
            histories["attn_lrs"], histories["eval_psnrs"], influ_np)
        main.save(os.path.join(log_dir, "train_main_plots",
                               f"{cfg.index}_iter_{step}.png"))
        pcd = plots.pcd_plot(cfg.index, step, train_rayo[0], train_rayd[0],
                             points_np, coord_scale, 0.8 * pt_plot_scale,
                             influ_np)
        pcd.save(os.path.join(log_dir, "train_pcd_plots",
                              f"{cfg.index}_iter_{step}.png"))


def _mesh_plan(cfg):
    """The (data, rays) ``ShardingPlan`` of ``tpu.mesh``, or None
    (``papr_tpu/train/loop.py _mesh_plan``): batch images over 'data',
    patch rows over 'rays', one rank per device. Raises ``ValueError`` when
    the batch or the patch does not split, or when the ranks running are
    not the mesh's (``parallel/mesh.py make_mesh``)."""
    data = int(cfg.get_path("tpu.mesh.data", 1))
    rays = int(cfg.get_path("tpu.mesh.rays", 1))
    pmesh.init_ranks()
    if data * rays <= 1 and pmesh.process_count() <= 1:
        return None
    bs = int(cfg.dataset.batch_size)
    ph = int(cfg.dataset.patches.height)
    if bs % data != 0:
        raise ValueError(f"dataset.batch_size={bs} must be divisible by "
                         f"tpu.mesh.data={data}")
    if ph % rays != 0:
        raise ValueError(f"dataset.patches.height={ph} must be divisible by "
                         f"tpu.mesh.rays={rays}")
    plan = pmesh.make_plan(pmesh.mesh_from_config(cfg))
    if plan.mesh.rank == 0:
        print(f"Multi-chip: mesh=(data={data}, rays={rays}) over "
              f"{data * rays} devices")
    return plan


def train_and_eval(cfg, eval_cfg, resume: int = 0):
    """Train ``cfg`` with the eval / checkpoint cadence of the reference
    loop -> (params, opt_state, state, histories). Under a mesh every rank
    returns the same replicated result."""
    plan = _mesh_plan(cfg)
    with pmesh.quiet_unless_main():
        return _train_and_eval(cfg, eval_cfg, resume, plan)


def _train_and_eval(cfg, eval_cfg, resume: int, plan):
    dev = platform_device()
    mesh = plan.mesh if plan is not None else None
    main = mesh is None or mesh.rank == 0
    log_dir = os.path.join(cfg.save_dir, cfg.index)
    test_dir = os.path.join(log_dir, "test")
    if main:
        os.makedirs(test_dir, exist_ok=True)

    dataset = get_dataset(cfg.dataset, mode="train", seed=int(cfg.seed))
    eval_dataset = get_dataset(eval_cfg.dataset, mode="test")
    trainloader = get_loader(dataset, cfg.dataset, mode="train")

    params, state = create_model(cfg, seed=int(cfg.seed), device=dev)
    specs = build_group_specs(cfg)
    opt_state = init_opt_state(params, specs)

    histories = {"steps": [], "train_losses": [], "eval_losses": [],
                 "eval_psnrs": [], "pt_lrs": [], "attn_lrs": []}
    start_step = 0
    if resume > 0:
        barrier(mesh)    # rank 0's checkpoint is complete before any reads it
    if resume > 0 and os.path.exists(os.path.join(log_dir, "checkpoint.npz")):
        start_step, tree = load_checkpoint(log_dir)
        params = restore_into(params, tree["params"])
        opt_state = restore_into(opt_state, tree["opt_state"])
        state = restore_into(state, tree["state"])
        histories.update(load_histories(log_dir))
        print(f"!!!!! Resume from step {start_step}")
    elif cfg.load_path:
        load_path = cfg.load_path
        if not os.path.isabs(load_path) and not os.path.exists(load_path):
            load_path = os.path.join(cfg.save_dir, load_path)
        if is_native(load_path):
            s, tree = load_checkpoint(load_path)
            params = restore_into(params, tree["params"])
            state = restore_into(state, tree["state"])
        else:   # the reference's model.pth (a file, or a directory with one)
            s, params, state, _ = import_torch(load_path, params, state, cfg)
        print(f"!!!!! Loaded model from {cfg.load_path} at step {s}")
    replicate(mesh, params, opt_state, state)

    loss_fn = build_loss(cfg, policy_from_config(cfg), device=dev)
    train_step = make_train_step(cfg, loss_fn=loss_fn, sharding=plan)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    last_act = build_activation(cfg.models.last_act)
    np_rng = np.random.default_rng(int(cfg.seed) + 1)

    tr = cfg.training
    step = start_step
    eval_step_cnt = start_step
    avg_train_loss = 0.0
    pruned = False
    pc_frames = []
    start_time = time.time()
    rays_in_window = 0

    # Optional profiler window: tpu.profile_start/profile_steps write a
    # torch.profiler chrome trace into <log_dir>/profile (the reference has
    # only wall-clock prints, train.py:257-260).
    profile_start = int(cfg.get_path("tpu.profile_start", -1))
    if not main:
        profile_start = -1
    profile_len = int(cfg.get_path("tpu.profile_steps", 10))
    profiler = None

    print("Start step:", start_step, "Total steps:", tr.steps)
    while step < tr.steps:
        for batch in device_prefetch(trainloader, device=dev, plan=plan):
            if profile_start >= 0 and step == profile_start:
                acts = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=acts)
                profiler.start()
            if profiler is not None and step == profile_start + profile_len:
                sync()
                profiler.stop()
                os.makedirs(os.path.join(log_dir, "profile"), exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(log_dir, "profile", "trace.json"))
                profiler = None
                print(f"profiler trace written to {log_dir}/profile")
            # ---- prune/grow scheduling (reference train.py:207-250) ----
            rebuild = False
            if (tr.prune_steps > 0 and tr.prune_start <= step < tr.prune_stop
                    and step % tr.prune_steps == 0):
                if len(tr.prune_steps_list) > 0:
                    thresh = tr.prune_thresh_list[
                        bisect.bisect_left(list(tr.prune_steps_list), step)]
                else:
                    thresh = tr.prune_thresh
                params, state, n_pruned = prune_points(params, state, thresh,
                                                       tr.prune_type)
                pruned, rebuild = True, True
                print(f"Step {step}: Pruned {n_pruned} points "
                      f"({int(state['alive'].sum().item())} left)")

            grow_now, grow_num = False, 0
            if pruned and len(tr.add_steps_list) > 0:
                if step in list(tr.add_steps_list):
                    grow_now = True
                    grow_num = tr.add_num_list[list(tr.add_steps_list).index(step)]
            elif (pruned and tr.add_steps > 0 and step % tr.add_steps == 0
                    and tr.add_start <= step < tr.add_stop):
                grow_now, grow_num = True, tr.add_num
            if grow_now:
                params, state, n_added = add_points(params, state, cfg,
                                                    grow_num, np_rng)
                rebuild = rebuild or n_added > 0
                print(f"Step {step}: Added {n_added} points "
                      f"({int(state['alive'].sum().item())} alive)")
            if rebuild:
                # = the reference's clear_optimizer + init_optimizers(step):
                # moments reset; schedules continue from the global step.
                opt_state = init_opt_state(params, specs)
                replicate(mesh, params, opt_state, state)

            # ---- the device step ----
            params, opt_state, loss, pred = train_step(
                params, opt_state, state, batch.rayo, batch.rayd, batch.image,
                batch.c2w, step)
            # Accumulate ON DEVICE: float(loss) here would make the host
            # wait for the card every step. The 200-step print and the eval
            # boundary synchronize instead.
            avg_train_loss = avg_train_loss + loss
            rays_in_window += batch.rayd[..., 0].numel() * (
                mesh.size if mesh is not None else 1)
            step += 1
            eval_step_cnt += 1

            if step % 200 == 0:
                sync()
                dt = time.time() - start_time
                lrs = current_lrs(specs, step)
                print(f"Train step: {step} loss: {float(loss):.6f} "
                      f"attn_lr: {lrs.get('attn', 0):.3e} "
                      f"pts_lr: {lrs.get('points', 0):.3e} "
                      f"time: {dt:.2f}s "
                      f"rays/s: {rays_in_window / max(dt, 1e-9):,.0f}")
                start_time = time.time()
                rays_in_window = 0

            if (step % cfg.eval.step == 0) or (step % 500 == 0 and step < 10000):
                lrs = current_lrs(specs, step)
                histories["train_losses"].append(
                    float(avg_train_loss) / eval_step_cnt)
                histories["pt_lrs"].append(lrs.get("points", 0.0))
                histories["attn_lrs"].append(lrs.get("attn", 0.0))
                histories["steps"].append(step)
                pred_np = _host(last_act(pred))
                eval_step(step, params, state, cfg, dataset, eval_dataset,
                          batch, loss_fn, pred_np, histories, log_dir,
                          write=main)
                if main:
                    save_checkpoint(log_dir, step, params, opt_state, state,
                                    histories=histories,
                                    keep_snapshot=(step % 50000 == 0))
                avg_train_loss, eval_step_cnt = 0.0, 0
                start_time = time.time()
                rays_in_window = 0

            if ((step - 1) % 200 == 0) and main and cfg.eval.save_fig \
                    and plots.available():
                pt_plot_scale = 0.8 * cfg.dataset.coord_scale
                if "Barn" in cfg.dataset.path:
                    pt_plot_scale *= 1.5
                if "Family" in cfg.dataset.path:
                    pt_plot_scale *= 0.5
                pc_dir = os.path.join(test_dir, "point_clouds")
                os.makedirs(pc_dir, exist_ok=True)
                alive = _host(state["alive"])
                frame = plots.pcd_single_plot(
                    step, _host(params["points"])[alive], pt_plot_scale,
                    _host(params["points_influ_scores"])[alive, 0])
                pc_frames.append(frame)
                if step == 1:
                    frame.save(os.path.join(pc_dir, "init_pcd.png"))

            if step >= tr.steps:
                break

    if cfg.eval.save_fig and pc_frames and main:
        from ..utils.video import write_video
        out = write_video(os.path.join(test_dir, f"{cfg.index}-pc.mp4"),
                          pc_frames, fps=30)
        print("point-cloud video:", out)

    if profiler is not None:
        profiler.stop()
    if main:
        save_checkpoint(log_dir, step, params, opt_state, state,
                        histories=histories)
    barrier(mesh)
    print("Training finished!")
    return params, opt_state, state, histories
