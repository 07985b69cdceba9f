"""cIMLE exposure-control finetuning CLI:
python -m papr_tpu_torch.cli.exposure --opt configs/t2/Caterpillar_exposure_control.yml [--resume 1]

The flags, config files, log files and output layout of the repository's
``exposure_control_finetune.py``: finetunes a pretrained model with
per-image latent shading codes -> mapping MLP -> FiLM modulation of the
UNet, resampling each image's code by best-of-N search every
``shading_code_resample_iter`` steps (reference :184-218). The pretrained
``load_path`` is a ``checkpoint.npz`` (restored leaf by leaf where shapes
match, the mapping MLP fresh) or a reference ``model.pth``. Runs on the GPU;
``PAPR_PLATFORM=cpu`` asks for the CPU. Under ``torchrun`` with a
``tpu.mesh`` of that many devices the resample and eval renders spread their
tiles over the ranks; the finetune step is not sharded (as in the JAX
package): every rank runs it alike. Rank 0 alone writes.
"""

import argparse
import copy
import os
import shutil
import sys
import time

import numpy as np

from ..config import Config, load_config, make_eval_config
from ..parallel.mesh import init_ranks, process_rank, quiet_unless_main
from ..utils.logging import Logger, setup_seed, snapshot_code


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PAPR (PyTorch / CUDA) exposure "
                                            "finetune")
    p.add_argument("--opt", type=str, default="", help="Option file path")
    p.add_argument("--resume", type=int, default=0, help="Resume training")
    return p.parse_args(argv)


def sample_config(cfg) -> Config:
    """The "sample" dataset's config: the same scenes at resample-sized
    patches (reference :312-349 builds a third config with patch size
    shading_code_resample_size)."""
    sample_dict = copy.deepcopy(dict(cfg))
    size = int(cfg.exposure_control.shading_code_resample_size)
    sample_dict["dataset"] = dict(sample_dict["dataset"])
    sample_dict["dataset"]["patches"] = dict(sample_dict["dataset"]["patches"])
    sample_dict["dataset"]["patches"]["height"] = size
    sample_dict["dataset"]["patches"]["width"] = size
    return Config(sample_dict)


def main(argv=None):
    cli = parse_args(argv)
    cfg = load_config(cli.opt)
    assert cfg.exposure_control.use, \
        "set exposure_control.use: true for this stage"
    eval_cfg = make_eval_config(cfg)
    sample_cfg = sample_config(cfg)

    init_ranks()
    if process_rank() == 0:
        log_dir = os.path.join(cfg.save_dir, cfg.index)
        os.makedirs(log_dir, exist_ok=True)
        sys.stdout = Logger(os.path.join(log_dir, "train.log"), sys.stdout)
        sys.stderr = Logger(os.path.join(log_dir, "train_error.log"),
                            sys.stderr)
        shutil.copyfile(__file__,
                        os.path.join(log_dir, os.path.basename(__file__)))
        if cli.opt:
            shutil.copyfile(cli.opt,
                            os.path.join(log_dir, os.path.basename(cli.opt)))
        snapshot_code(".", os.path.join(log_dir, "code.zip"))
    setup_seed(cfg.seed)

    with quiet_unless_main():
        return run(cfg, eval_cfg, sample_cfg, cli.resume)


def load_pretrained(cfg, params, state):
    """``cfg.load_path`` into (params, state): a ``checkpoint.npz`` (or a
    directory with one) leaf by leaf where the shapes match, so the mapping
    MLP a pretrained run lacks stays fresh; anything else through
    ``import_torch`` (the reference's model.pth) -> (params, state, step)."""
    import torch

    from ..train.checkpoint import (_flatten, _unflatten, import_torch,
                                    is_native, load_checkpoint, restore_into)
    load_path = cfg.load_path
    if not os.path.isabs(load_path) and not os.path.exists(load_path):
        load_path = os.path.join(cfg.save_dir, load_path)
    if not is_native(load_path):
        s, params, state, _ = import_torch(load_path, params, state, cfg)
        return params, state, s
    s, tree = load_checkpoint(load_path)
    flat_t = _flatten(params)
    flat_l = _flatten(tree["params"])
    for k, ref in flat_t.items():
        if k in flat_l and tuple(np.shape(flat_l[k])) == tuple(ref.shape):
            flat_t[k] = torch.from_numpy(np.array(flat_l[k])).to(
                device=ref.device, dtype=ref.dtype)
    return _unflatten(flat_t), restore_into(state, tree["state"]), s


def run(cfg, eval_cfg, sample_cfg, resume):
    """Finetune ``cfg`` -> (params, opt_state, state, codes, histories)."""
    import torch

    from ..dataset import get_dataset, get_loader
    from ..dataset.dataset import device_prefetch
    from ..device import platform_device
    from ..model.papr import create_model
    from ..nn.activations import build_activation
    from ..nn.mlp import policy_from_config
    from ..train.checkpoint import (load_checkpoint, load_histories,
                                    restore_into, save_checkpoint)
    from ..train.exposure import (_candidate_scores_fn, init_shading_codes,
                                  resample_shading_codes)
    from ..train.loop import eval_step
    from ..train.losses import build_loss
    from ..parallel.collectives import barrier, replicate
    from ..train.optim import build_group_specs, current_lrs, init_opt_state
    from ..train.step import _render_mesh, make_train_step

    # The ranks the renders spread over, or None: one process.
    mesh = _render_mesh(cfg)
    main = mesh is None or mesh.rank == 0
    dev = platform_device()
    log_dir = os.path.join(cfg.save_dir, cfg.index)
    dataset = get_dataset(cfg.dataset, mode="train", seed=int(cfg.seed))
    sample_dataset = get_dataset(sample_cfg.dataset, mode="train",
                                 seed=int(cfg.seed))
    eval_dataset = get_dataset(eval_cfg.dataset, mode="test")
    trainloader = get_loader(dataset, cfg.dataset, mode="train")

    params, state = create_model(cfg, seed=int(cfg.seed), device=dev)
    specs = build_group_specs(cfg)
    opt_state = init_opt_state(params, specs)
    histories = {"steps": [], "train_losses": [], "eval_losses": [],
                 "eval_psnrs": [], "pt_lrs": [], "attn_lrs": []}
    np_rng = np.random.default_rng(int(cfg.seed) + 2)

    start_step = 0
    codes = None
    if resume > 0:
        barrier(mesh)    # rank 0's checkpoint is complete before any reads it
    if resume > 0 and os.path.exists(os.path.join(log_dir, "checkpoint.npz")):
        start_step, tree = load_checkpoint(log_dir)
        params = restore_into(params, tree["params"])
        opt_state = restore_into(opt_state, tree["opt_state"])
        state = restore_into(state, tree["state"])
        codes = {k: np.asarray(v, np.float32)
                 for k, v in tree.get("extras", {}).items()}
        histories.update(load_histories(log_dir))
        print(f"!!!!! Resume from step {start_step}")
    elif cfg.load_path:
        params, state, s = load_pretrained(cfg, params, state)
        print(f"!!!!! Loaded pretrained model from {cfg.load_path} (step {s})")

    if codes is None:
        codes = {
            "train_shading_codes": init_shading_codes(np_rng, len(dataset), cfg),
            "eval_shading_codes": init_shading_codes(np_rng, len(eval_dataset),
                                                     cfg),
        }
    print("!!!!! train_shading_codes:", codes["train_shading_codes"].shape)
    replicate(mesh, params, opt_state, state)

    loss_fn = build_loss(cfg, policy_from_config(cfg), device=dev)
    train_step = make_train_step(cfg, loss_fn=loss_fn)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    last_act = build_activation(cfg.models.last_act)
    # select_by 'loss' ranks candidates by the full training loss
    # (reference utils.py:479-481), not by MSE.
    score_fn = _candidate_scores_fn(cfg, loss_fn=loss_fn)

    tr = cfg.training
    ec = cfg.exposure_control
    step, eval_cnt, avg_loss = start_step, max(start_step, 1), 0.0
    start_time = time.time()
    print("Start step:", start_step, "Total steps:", tr.steps)
    while step < tr.steps:
        for batch in device_prefetch(trainloader, device=dev):
            if step % int(ec.shading_code_resample_iter) == 0:
                print("Resampling shading codes")
                for img_idx in range(len(sample_dataset)):
                    resample_shading_codes(
                        codes["train_shading_codes"], cfg, params, state,
                        sample_dataset, img_idx, step, np_rng, score_fn)
                print("Resampled", len(sample_dataset), "codes")

            code = torch.as_tensor(
                codes["train_shading_codes"][int(batch.img_idx[0])],
                device=dev)
            params, opt_state, loss, pred = train_step(
                params, opt_state, state, batch.rayo, batch.rayd, batch.image,
                batch.c2w, step, shading_code=code)
            # Accumulated on the device (see train/loop.py).
            avg_loss = avg_loss + loss
            step += 1
            eval_cnt += 1

            if step % 200 == 0:
                sync()
                dt = time.time() - start_time
                lrs = current_lrs(specs, step)
                print(f"Train step: {step} loss: {float(loss):.6f} "
                      f"mapping_lr: {lrs.get('mapping_mlp', 0):.3e} "
                      f"time: {dt:.2f}s")
                start_time = time.time()

            if (step % cfg.eval.step == 0) or (step % 500 == 0 and step < 10000):
                lrs = current_lrs(specs, step)
                histories["train_losses"].append(float(avg_loss) / eval_cnt)
                histories["pt_lrs"].append(lrs.get("points", 0.0))
                histories["attn_lrs"].append(lrs.get("attn", 0.0))
                histories["steps"].append(step)
                pred_np = last_act(pred).detach().cpu().numpy()
                eval_code = codes["eval_shading_codes"][int(cfg.eval.img_idx)]
                eval_step(step, params, state, cfg, dataset, eval_dataset,
                          batch, loss_fn, pred_np, histories, log_dir,
                          eval_shading_code=eval_code, write=main)
                if main:
                    save_checkpoint(log_dir, step, params, opt_state, state,
                                    extras=codes, histories=histories,
                                    keep_snapshot=(step % 50000 == 0))
                avg_loss, eval_cnt = 0.0, 0

            if step >= tr.steps:
                break

    if main:
        save_checkpoint(log_dir, step, params, opt_state, state,
                        extras=codes, histories=histories)
    barrier(mesh)
    print("Training finished!")
    return params, opt_state, state, codes, histories


if __name__ == "__main__":
    main()
