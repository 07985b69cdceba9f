"""Phase 2's and phase 8's kernel comparisons of one source tree, in its own
process, for a parent / change / change / parent run on one card:

    python tools/torch_ab_kernels.py <tree>      # needs a card and nvcc

    python tools/torch_ab_kernels.py <tree> --digest-only

    python tools/torch_ab_kernels.py <tree> --frames

<tree> is a checkout holding ``chip_smoke.py`` and ``papr_tpu_torch/`` (for
the parent, ``git archive`` of it unpacked into a git-ignored directory);
its kernels are built from its own sources. Prints digests (equal
digests: bit-equal outputs) of the bf16 and fp32 one-shot eval attention's
outputs on phase 2's eval block, of the bf16 stream forwards' and
backwards' and the fp32 stream forwards' outputs on phase 2's training
patch (queries from the plain query embedder; the value forwards fed the
plain key forward's attention in their dtype; the
backwards the plain forwards' raw dots, scores and attention and seeded
cotangents: inputs both trees compute alike), of the fp32 stream
backwards' (rows 5f / 6f bwd), the int8 stream forwards' (rows 5q / 6q,
5qf / 6qf) and the bf16 folded key stream's (row 7, fwd and bwd) on the
same inputs, of the fp32 feature stream forwards' (rows 8f
/ 9f fwd) on the inputs the model's head builds from the patch, of the
bf16 and fp32 query embedder's forward (K2, row 2f) and backward (row 3,
row 3f) on the patch's rays (a seeded cotangent), and of the culled
top-k's stage 3 (K1) at the serving shape
(the 800x800 orbit frame, early exit) and the training shape (the patch,
one 2048 chunk); then chip_smoke's phase 2
lines (the flagship's kernels) and phase 8 lines (Caterpillar's
fp32 kernels); a comparison that fails prints ``FAILS:`` and the run goes
on. ``--digest-only`` stops after the digests; ``--frames`` runs instead
chip_smoke's phase 3 (an 800x800 serving frame and the 100x100-tiled
frame, host clock) twice on the tree.
"""

import hashlib
import os
import sys


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> None:
    tree = os.path.abspath(sys.argv[1])
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from papr_tpu_torch.kernels import build
    from papr_tpu_torch.ops import fused_mlp as fm
    from papr_tpu_torch.ops import stream_attn as sa
    from papr_tpu_torch.ops import stream_feat as sf

    cs.fail = lambda m: print("FAILS:", m, flush=True)
    build.load()
    dev = torch.device("cuda", 0)
    cfg = cs.flagship_cfg()
    params, state = cs.build_model(cfg, dev)
    if "--frames" in sys.argv:
        for _ in range(2):
            cs.drive_main_path(params, state, cfg, dev)
        return
    # The digested kernels' inputs come from the plain query embedder, so
    # that they do not depend on the tree's K2.
    k2 = fm.fused_mlp
    fm.fused_mlp = fm.fused_mlp_plain
    try:
        args, T = cs.eval_block_args(params, state, cfg, dev)
        rayo, rayd = cs.training_patch(dev)
        idx, _, rec, rayo_f, rays, rayd_f, qq, kwalk, vwalk = \
            cs.stream_patch_inputs(params, state, cfg, rayo, rayd)
    finally:
        fm.fused_mlp = k2
    print(f"K3 bf16 outputs on the eval block (T={T}): sha256 "
          f"{digest(sa.attend_eval_idx(*args))}", flush=True)
    print(f"K3 fp32 outputs on the eval block (T={T}): sha256 "
          f"{digest(sa.attend_eval_idx(*args[:-1], torch.float32))}",
          flush=True)
    del args
    a = params["attn"]
    kopts = (cfg.models.attn.score_act, float(cfg.geoms.background.constant),
             float(cfg.eps), torch.bfloat16)
    attn, raw, ss = sa.key_stream_plain(rec, rayo_f, rays, qq, kwalk,
                                        a["w_k"]["w"], a["w_k"]["bias"],
                                        *kopts)
    g = torch.Generator(device=dev).manual_seed(5)
    dattn = torch.randn(attn.shape, generator=g, device=dev)
    dfused = torch.randn(attn.shape[0], int(vwalk.ws[-1].shape[1]),
                         generator=g, device=dev)
    print("bf16 stream forwards on the training patch: key sha256 "
          + digest(sa.key_stream_fwd(rec, rayo_f, rays, qq, kwalk,
                                     a["w_k"]["w"], a["w_k"]["bias"], *kopts))
          + ", value sha256 "
          + digest([sa.value_stream_fwd(rec, rayo_f, rays, attn, vwalk,
                                        bool(cfg.models.normalize_topk_attn),
                                        float(cfg.eps), torch.bfloat16)]),
          flush=True)
    print("bf16 stream backwards on the training patch: key sha256 "
          + digest(sa.key_stream_bwd(rec, rayo_f, rays, qq, kwalk,
                                     a["w_k"]["w"], a["w_k"]["bias"], raw,
                                     ss, dattn, *kopts))
          + ", value sha256 "
          + digest(sa.value_stream_bwd(rec, rayo_f, rays, attn, vwalk, dfused,
                                       bool(cfg.models.normalize_topk_attn),
                                       float(cfg.eps), torch.bfloat16)),
          flush=True)
    kopts32 = kopts[:3] + (torch.float32,)
    attn32 = sa.key_stream_plain(rec, rayo_f, rays, qq, kwalk, a["w_k"]["w"],
                                 a["w_k"]["bias"], *kopts32)[0]
    print("fp32 stream forwards on the training patch: key sha256 "
          + digest(sa.key_stream_fwd(rec, rayo_f, rays, qq, kwalk,
                                     a["w_k"]["w"], a["w_k"]["bias"],
                                     *kopts32))
          + ", value sha256 "
          + digest([sa.value_stream_fwd(rec, rayo_f, rays, attn32, vwalk,
                                        bool(cfg.models.normalize_topk_attn),
                                        float(cfg.eps), torch.float32)]),
          flush=True)
    # Rows 5q / 6q and 5qf / 6qf (the int8 stream forwards, on walk.cuh's
    # WMMA int8 walk), each calibrated on its own inputs.
    for name, cdt, at in (("bf16", torch.bfloat16, attn),
                          ("fp32", torch.float32, attn32)):
        ko = kopts[:3] + (cdt,)
        print(f"int8 stream forwards ({name} epilogue) on the training "
              "patch: key sha256 "
              + digest(sa.key_stream_fwd(rec, rayo_f, rays, qq, kwalk,
                                         a["w_k"]["w"], a["w_k"]["bias"], *ko,
                                         int8=True))
              + ", value sha256 "
              + digest([sa.value_stream_fwd(
                  rec, rayo_f, rays, at, vwalk,
                  bool(cfg.models.normalize_topk_attn), float(cfg.eps), cdt,
                  int8=True)]), flush=True)
    _, raw32, ss32 = sa.key_stream_plain(rec, rayo_f, rays, qq, kwalk,
                                         a["w_k"]["w"], a["w_k"]["bias"],
                                         *kopts32)
    print("fp32 stream backwards on the training patch: key sha256 "
          + digest(sa.key_stream_bwd(rec, rayo_f, rays, qq, kwalk,
                                     a["w_k"]["w"], a["w_k"]["bias"], raw32,
                                     ss32, dattn, *kopts32))
          + ", value sha256 "
          + digest(sa.value_stream_bwd(rec, rayo_f, rays, attn32, vwalk,
                                       dfused,
                                       bool(cfg.models.normalize_topk_attn),
                                       float(cfg.eps), torch.float32)),
          flush=True)
    qwalk = cs.query_walk(params, cfg)
    # Row 7 (bf16, the folded key stream on its WMMA kernels), from the
    # plain forward's raw dots and scores.
    qargs = (rec, rayo_f, rays, rayd_f.contiguous(), kwalk, a["w_k"]["w"],
             a["w_k"]["bias"], qwalk, a["w_q"]["w"], a["w_q"]["bias"])
    _, raw_q, ss_q, qq_q = sa.key_stream_q_plain(*qargs, *kopts)
    print("bf16 folded key stream on the training patch: fwd sha256 "
          + digest(sa.key_stream_q_fwd(*qargs, *kopts)) + ", bwd sha256 "
          + digest(sa.key_stream_q_bwd(*qargs, qq_q, raw_q, ss_q, dattn,
                                       *kopts)), flush=True)
    # Rows 8f / 9f fwd (the fp32 feature forwards) on the inputs the
    # model's head builds from the patch's selection.
    from papr_tpu_torch.model.papr import _stream_inputs, model_meta
    with torch.no_grad():
        xk, kwalk_f, xv, vwalk_f, influ, sel_alive, _ = _stream_inputs(
            params, cfg, model_meta(cfg), idx, rayo, rayd, state["alive"],
            float(cfg.eps))
    print("fp32 feature stream forwards on the training patch: key sha256 "
          + digest(sf.key_stream_feat_fwd(
              xk.contiguous(), qq, kwalk_f, a["w_k"]["w"], a["w_k"]["bias"],
              influ.contiguous(), sel_alive.contiguous(), kopts[0], kopts[1],
              torch.float32))
          + ", value sha256 "
          + digest([sf.value_stream_feat_fwd(
              xv.contiguous(), attn32, vwalk_f,
              bool(cfg.models.normalize_topk_attn), torch.float32)]),
          flush=True)
    del rec, attn, raw, ss, dattn, dfused, attn32, raw32, ss32, qargs, xk, xv
    x = rayd.reshape(-1, 3).contiguous()
    dy = torch.randn(x.shape[0], int(qwalk.ws[-1].shape[1]), generator=g,
                     device=dev)
    for name, cdt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        print(f"{name} query embedder on the training patch's rays: "
              f"{'K2' if name == 'bf16' else 'row 2f'} sha256 "
              + digest([fm.fused_mlp(x, qwalk, cdt)])
              + f", {'row 3' if name == 'bf16' else 'row 3f'} sha256 "
              + digest((lambda r: [r[0]] + list(r[1]))(
                  fm.fused_mlp_bwd(x, dy, qwalk, cdt))), flush=True)
    from papr_tpu_torch.model.papr import model_meta
    from papr_tpu_torch.ops import tile_cull as tc
    from papr_tpu_torch.ops.geometry import get_rays
    k = model_meta(cfg).select_k
    pts, alive = params["points"], state["alive"]
    c2w = torch.as_tensor(cs.orbit(0.0), device=dev)
    focal = torch.tensor([cs.FOCAL, cs.FOCAL], device=dev)
    frame_o, frame_d = get_rays(cs.H, cs.W, c2w, focal)
    for name, (o, d, pre) in (("serving", (frame_o[0], frame_d, "packsort")),
                              ("training", (rayo[0], rayd[0], "approx"))):
        tiles, f, recs, chunk, ee, _ = tc.cull_inputs(
            pts, alive, o, d, M=2048, block=16, eps=float(cfg.eps),
            prefilter=pre, early_exit=True)
        print(f"K1 at the {name} shape (tiles {tuple(tiles.shape)}, chunk "
              f"{chunk}, early exit {ee}): sha256 "
              + digest([tc.cull_select(tiles, f, recs, k, chunk, ee)]),
              flush=True)
    torch.cuda.empty_cache()
    if "--digest-only" in sys.argv:
        return
    cs.compare_kernels(params, state, cfg, dev)
    cs.compare_train_kernels(params, state, cfg, dev)
    cs.compare_cli_kernels(params, state, cfg, dev)
    cs.compare_int8_kernels(params, state, cfg, dev)
    del params, state
    torch.cuda.empty_cache()
    cfg = cs.caterpillar_cfg()
    params, state = cs.build_model(cfg, dev)
    _, rayo, rayd, _ = cs.sphere_view(cfg, dev)
    cs.compare_f32_kernels(params, state, cfg, dev, rayo, rayd, 180)


if __name__ == "__main__":
    main()
