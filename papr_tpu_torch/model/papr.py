"""PAPR model: learned point cloud + proximity attention + UNet decode
(``papr_tpu/model/papr.py``), for serving (``evaluate``) and training
(``forward``).

Parameters are the JAX package's tree as plain dicts of tensors: the point
cloud is padded to ``max_num_pts`` with an ``alive`` mask (dead slots parked
at 1e8), so ``papr_tpu_torch.convert.from_jax_params`` copies a JAX model
leaf by leaf and both packages compute the same function.

Pipeline per ray (reference models/model.py:494-560): top-k by point-to-ray
distance -> geometric k/q/v -> posenc + FFN embedders -> scaled-dot scores
-> x influence -> softmax with a background token -> renormalized
foreground attention -> feature fusion -> UNet -> composite with the
background color.

Device-aware reading of the ``tpu.*`` keys (the port adds no config group):

* ``topk_impl: auto`` -> the tile-culled selection when P <= 32768 (its
  stage-3 kernel on the card, the plain version on the CPU), exact selection
  otherwise; ``cull`` / ``xla`` pin either. ``pallas`` -> the streaming
  top-k over every point (``ops/pallas_topk.py``: ``csrc/topk_stream.cu`` on
  the card, its plain version on the CPU; P <= 32768). ``approx``
  (``approx_min_k`` over every point in the JAX package, which returns the
  exact selection off the TPU) -> the exact selection, as ``xla``.
* ``fused_attn: auto`` (fusible configs) or ``streamrec`` -> the fused
  query embedder, then for eval the one-shot eval attention and for
  training the key and value streams with their backwards (kernels on the
  card, plain versions on the CPU). ``true`` | ``embed`` | ``score`` -> the
  split-kernel path on k-major tokens: ``true`` / ``embed`` run the fused
  embedder (forward and backward kernels) on the key, query and value
  stacks, ``true`` / ``score`` run ``ops/fused_attn.py fused_scores``
  (forward and backward kernels) for the projections, scores and softmax;
  the stage a value leaves out is plain PyTorch, and the
  renormalize-and-fuse epilogue always is. ``false`` -> the plain unfused
  PyTorch path, differentiable, the parity oracle; a config the kernels do
  not cover takes it too. ``stream`` -> the fused query embedder, then the
  key and value streams that read raw k-major feature tensors
  (``ops/stream_feat.py``), for training and, forward only, for eval.
* ``query_fold: true`` with ``streamrec`` -> the query chain (posenc ->
  query embedder -> ``w_q``) runs inside the key stream kernel
  (``key_stream_scores_recq``), for training and eval; under any other
  kernel mode it warns once and the query chain runs unfolded.
* ``eval_fused: false`` (with ``streamrec``, at eval) -> the two training
  stream kernels' forwards on the k-major gathered record under
  ``torch.no_grad()`` instead of the one-shot eval kernel; a folded query
  turns the one-shot kernel off in the same way.
* Training selection reads ``tpu.cull_prefilter`` (default ``approx``, read
  as the exact top-k of the cone lower bounds, see ``ops/tile_cull.py``);
  eval pins ``tpu.cull_prefilter_eval`` like the JAX eval path.
* Compute dtype: ``use_amp: true`` runs the kernels in bf16, ``use_amp:
  false`` in fp32: every kernel of every mode has both forms (the fp32 ones
  are the same kernels on the fp32 walk, 3xTF32 products, nothing rounded
  to bf16), and the int8 walks run beside either (their epilogue in the
  compute dtype). On the CPU every mode runs its plain versions in either
  dtype.
* Embedder dropout (``dropout_ff > 0``): a training call given a dropout
  generator (``train/step.py`` derives one from the seed and the step) takes
  the plain path with dropout, as the JAX package's ``fusible`` does; eval
  and render calls keep the kernels (dropout is off there). A ``tpu.mesh``
  of more than one device raises (single-card slice, Queue 1 item 4).
* ``int8_eval: true`` -> at eval, under ``streamrec`` with ``eval_fused``
  and no folded query, the one-shot eval attention runs both walks' dense
  stacks in int8 (``attend_eval_i8``), calibrated once per frame by
  ``eval_quant_params`` in the tiled renders and per call otherwise. Under
  ``streamrec`` without the one-shot kernel (``eval_fused: false``,
  ``query_fold``) and under ``stream`` it warns once and the kernels
  without int8 run, bit-equal to the config without the knob. Training
  never reads it.
* ``int8_train: true`` -> in training, under ``streamrec`` without a folded
  query, the key and value streams' forwards run their walks in int8
  (``key_stream_i8_fwd`` / ``value_stream_i8_fwd``, calibrated per call);
  the backwards are the recompute in the compute dtype, unchanged. Under
  ``query_fold`` or ``stream`` it warns once and trains without int8. Eval
  never reads it.
* Under ``true`` | ``embed`` | ``score`` | ``false`` neither int8 knob does
  or says anything, as in the JAX package.
* The TPU tuning knobs (``fused_tile``, ``vmem_mb``, ``mxu_reduce``,
  ``force_local``, ``remat_embed``, ``donate_state``) select no computation
  and have no meaning on the card.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..nn.mlp import (F32, Policy, linear_apply, mlp_apply, mlp_init,
                      policy_from_config)
from ..nn.unet import small_unet_apply, small_unet_init
from ..ops.geometry import normalize_vector, point_ray_geometry
from ..ops.topk import select_topk
from .attention import attention_init, embed_kqv, score_fusible, score_tail

NEG_BIG = -1e30  # score for dead points: 0 softmax weight


# -------------------------------------------------------------- point init --

def sphere_points(center, num_pts: int, scale) -> np.ndarray:
    """Fibonacci sphere (reference: models/model.py:194-207)."""
    phi = math.pi * (3.0 - math.sqrt(5.0))
    i = np.arange(num_pts, dtype=np.float64)
    y = 1 - (i / max(num_pts - 1, 1)) * 2
    radius = np.sqrt(np.maximum(1 - y * y, 0))
    theta = phi * i
    pts = np.stack([np.cos(theta) * radius * scale[0] + center[0],
                    y * scale[1] + center[1],
                    np.sin(theta) * radius * scale[2] + center[2]], axis=-1)
    return pts.astype(np.float32)


def cube_points(rng: np.random.Generator, center, num_pts: int,
                scale) -> np.ndarray:
    """Regular grid + uniform remainder (reference: models/model.py:239-256)."""
    n_axis = int(num_pts ** (1.0 / 3.0))
    xs = np.linspace(-scale[0], scale[0], n_axis) + center[0]
    ys = np.linspace(-scale[1], scale[1], n_axis) + center[1]
    zs = np.linspace(-scale[2], scale[2], n_axis) + center[2]
    grid = np.array([[i, j, k] for i in xs for j in ys for k in zs])
    rest = num_pts - grid.shape[0]
    if rest > 0:
        rnd = np.stack([rng.uniform(-scale[a], scale[a], rest) + center[a]
                        for a in range(3)], axis=-1)
        grid = np.concatenate([grid, rnd], axis=0)
    return grid.astype(np.float32)


def load_point_cloud(path: str, max_num_pts: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Initial cloud from .pth/.pt or .npy/.npz, shuffled then truncated."""
    if path.endswith((".pth", ".pt")):
        pts = np.asarray(torch.load(path, map_location="cpu")).astype(np.float32)
    else:
        pts = np.load(path)
        if hasattr(pts, "files"):
            pts = pts[pts.files[0]]
        pts = np.asarray(pts, np.float32)
    rng.shuffle(pts)
    if max_num_pts > 0:
        pts = pts[:max_num_pts]
    return pts


# ------------------------------------------------------------------ config --

@dataclass
class ModelMeta:
    """Static facts derived from the config."""
    pad_num_pts: int
    select_k: int
    use_pc_feats: bool
    use_renderer: bool
    use_mapping_mlp: bool
    bkg_learnable: bool
    feat_dim: int


def model_meta(cfg) -> ModelMeta:
    pc = cfg.geoms.point_feats
    max_pts = int(cfg.max_num_pts)
    init_num = int(cfg.geoms.points.init_num)
    pad = max_pts if max_pts > 0 else init_num
    return ModelMeta(
        pad_num_pts=max(pad, init_num),
        select_k=int(cfg.geoms.points.select_k),
        use_pc_feats=bool(pc.use_ink or pc.use_inq or pc.use_inv),
        use_renderer=bool(cfg.models.use_renderer),
        use_mapping_mlp=bool(cfg.exposure_control.use),
        bkg_learnable=bool(cfg.geoms.background.learnable),
        feat_dim=int(cfg.models.attn.embed.value.d_ff_out),
    )


# -------------------------------------------------------------------- init --

def create_model(cfg, seed: int = 0, device=None,
                 init_points: np.ndarray | None = None):
    """Build (params, state) on ``device`` (``None``: the card, and an error
    without one); ``state`` holds the alive mask.

    Points come from the config's init (numpy, seeded by ``cfg.seed``, so
    they equal the JAX package's); weights are drawn from a
    ``torch.Generator`` seeded with ``seed``. Slots beyond the live count are
    parked at 1e8 and masked."""
    meta = model_meta(cfg)
    point_opt = cfg.geoms.points
    np_rng = np.random.default_rng(int(cfg.seed))
    if init_points is None and point_opt.load_path:
        init_points = load_point_cloud(point_opt.load_path, cfg.max_num_pts,
                                       np_rng)
    if init_points is None:
        center = [c * cfg.dataset.coord_scale for c in point_opt.init_center]
        scale = [s * cfg.dataset.coord_scale for s in point_opt.init_scale]
        if point_opt.init_type == "sphere":
            init_points = sphere_points(center, point_opt.init_num, scale)
        elif point_opt.init_type == "cube":
            init_points = cube_points(np_rng, center, point_opt.init_num,
                                      scale)
        else:
            raise NotImplementedError(
                f"Point init type [{point_opt.init_type}] is not found")

    n_live = init_points.shape[0]
    P = meta.pad_num_pts
    assert n_live <= P, (n_live, P)
    points = np.full((P, 3), 1e8, np.float32)
    points[:n_live] = init_points
    alive = np.zeros((P,), bool)
    alive[:n_live] = True

    gen = torch.Generator().manual_seed(int(seed))
    dev = resolve_device(device)
    params: dict[str, Any] = {
        "points": torch.from_numpy(points).to(dev),
        "points_influ_scores": torch.full(
            (P, 1), float(point_opt.influ_init_val), dtype=torch.float32,
            device=dev),
    }
    pc = cfg.geoms.point_feats
    extra = {"k": 0, "q": 0, "v": 0}
    if meta.use_pc_feats:
        params["pc_feats"] = torch.randn(P, int(pc.dim), generator=gen).to(dev)
        for name, flag in (("k", pc.use_ink), ("q", pc.use_inq),
                           ("v", pc.use_inv)):
            if flag:
                extra[name] = int(pc.dim)
    params["attn"] = attention_init(gen, cfg.models.attn, extra["k"],
                                    extra["q"], extra["v"], dev)
    if meta.use_renderer:
        g = cfg.models.renderer.generator
        if g.type == "small-unet":
            su = g.small_unet
            params["renderer"] = small_unet_init(
                gen, meta.feat_dim, 3, bilinear=su.bilinear, single=su.single,
                render_scale=int(su.get("render_scale", 1)), device=dev)
        elif g.type == "mlp":
            m = g.mlp
            params["renderer"] = mlp_init(
                gen, meta.feat_dim, m.num_layers, m.num_channels, 3,
                use_wn=m.use_wn, skip_layers=tuple(m.skip_layers),
                bias=m.bias, half_layers=tuple(m.half_layers), device=dev)
        else:
            raise NotImplementedError(f"generator type [{g.type}]")
    else:
        assert meta.feat_dim == 3, \
            "Value embedding MLP should have output dim 3 if not using renderer"
    params["bkg_feats"] = torch.tensor(
        np.asarray(cfg.geoms.background.init_color, np.float32)[None, :],
        device=dev)
    if meta.use_mapping_mlp:
        ec = cfg.exposure_control
        params["mapping_mlp"] = mlp_init(
            gen, int(ec.shading_code_dim), int(ec.mapping_mlp.num_layers),
            int(ec.mapping_mlp.dim), int(ec.mapping_mlp.out_dim),
            use_wn=ec.mapping_mlp.use_wn, device=dev)
    state = {"alive": torch.from_numpy(alive).to(dev)}
    return params, state


# ----------------------------------------------------------------- forward --

def _point_record(params, alive, meta, pcf) -> torch.Tensor:
    """Lane-aligned per-point record [xyz, influ, alive, pc_feats?, pad]."""
    parts = [params["points"], params["points_influ_scores"],
             alive.float()[:, None]]
    if meta.use_pc_feats:
        parts.append(params["pc_feats"])
    width = 3 + 1 + 1 + (int(pcf.dim) if meta.use_pc_feats else 0)
    pad = -(-width // 128) * 128 - width
    record = torch.cat(parts, dim=1)
    if pad:
        record = torch.nn.functional.pad(record, (0, pad))
    return record.contiguous()


def _check_single_device(cfg) -> None:
    data = int(cfg.get_path("tpu.mesh.data", 1))
    rays = int(cfg.get_path("tpu.mesh.rays", 1))
    if data * rays > 1:
        raise NotImplementedError(
            f"tpu.mesh {data}x{rays}: the multi-device render is ROADMAP.md "
            "Queue 1 item 4; this port renders on one card")


def resolve_topk_impl(cfg, P: int) -> str:
    """``tpu.topk_impl`` -> 'cull', 'pallas' or 'xla' (see module
    docstring)."""
    impl = cfg.get_path("tpu.topk_impl", "auto")
    if impl == "auto":
        return "cull" if P <= (1 << 15) else "xla"
    if impl in ("cull", "pallas", "xla"):
        return impl
    if impl == "approx":
        # approx_min_k returns the exact selection off the TPU.
        return "xla"
    raise ValueError(f"unknown tpu.topk_impl {impl!r}")


def resolve_fused_attn(cfg, fusible: bool):
    """``tpu.fused_attn`` -> 'streamrec', 'stream', True, 'embed' or 'score'
    (the kernels that run) or False (the plain path); see the module
    docstring."""
    fa = cfg.get_path("tpu.fused_attn", "auto")
    if fa == "auto":
        fa = "streamrec"
    if fa is False:
        return False
    if fa is True or fa in ("streamrec", "stream", "embed", "score"):
        return fa if fusible else False
    raise ValueError(f"unknown tpu.fused_attn {fa!r}")


_warned: set = set()


def _warn_qfold_ignored(why: str) -> None:
    """One-time warning when ``tpu.query_fold: true`` cannot take effect
    (the folded kernel exists only on the record-native stream path)."""
    key = f"qfold:{why}"
    if key not in _warned:
        _warned.add(key)
        import warnings
        warnings.warn(
            f"tpu.query_fold: true ignored — {why}; the query chain runs "
            "unfolded. The folded kernel needs tpu.fused_attn: streamrec "
            "and no per-point query features (point_feats.use_inq).")


def _warn_int8_ignored(why: str, knob: str = "int8_eval") -> None:
    """One-time warning when a ``tpu.int8_*: true`` knob cannot take effect
    (int8 walks exist only in the record-native streamed kernels)."""
    key = f"int8:{why}"
    if key not in _warned:
        _warned.add(key)
        import warnings
        warnings.warn(
            f"tpu.{knob}: true ignored — {why}; walks stay bf16/fp32. "
            "Int8 eval needs tpu.fused_attn: streamrec with "
            "tpu.eval_fused: true (the one-shot eval kernel) on an "
            "eval/render call; int8 train needs the rec-native "
            "two-kernel path (streamrec, no query folding).")


def resolve_query_fold(cfg, fa) -> bool:
    """``tpu.query_fold`` on a kernel path ``fa``: True under ``streamrec``
    (a fusible config has no per-point query features); under any other
    kernel mode a one-time warning, and False."""
    if not bool(cfg.get_path("tpu.query_fold", False)):
        return False
    if fa == "streamrec":
        return True
    _warn_qfold_ignored("rec-native streamrec preconditions do not hold "
                        "(rec_native=False, q_extra=None)")
    return False


def _kernel_mode(cfg, k: int, dropout=False):
    """The attention path of a selection of k points: ``tpu.fused_attn``
    resolved against what the kernels cover (False: the plain path; always
    for a training call with ``dropout``), and whether the query chain folds
    into the key stream. Every mode has its kernels in bf16 and fp32, so the
    answer depends on neither the device nor the compute dtype."""
    from ..ops.fused_mlp import feedforward_fusible
    e = cfg.models.attn.embed
    fusible = (not dropout and k <= 64 and not cfg.geoms.point_feats.use_inq
               and score_fusible(cfg.models.attn)
               and all(feedforward_fusible(c)
                       for c in (e.key, e.query, e.value)))
    fa = resolve_fused_attn(cfg, fusible)
    qfold = fa is not False and resolve_query_fold(cfg, fa)
    return fa, qfold


def _one_shot_eval(cfg, fa, qfold: bool) -> bool:
    """Whether an eval call takes the one-shot eval attention kernel."""
    return (fa == "streamrec" and not qfold
            and bool(cfg.get_path("tpu.eval_fused", True)))


def _attend(params: dict, state: dict, cfg, rays_o, rays_d, policy: Policy,
            exact_select: bool = True, quant_params=None, dropout_rng=None):
    """Selection + attention + fusion.

    rays_o (N, 3), rays_d (N, H, W, 3) on the parameters' device ->
    fused (N, H, W, C) fp32, attn (N, H, W, K+1) fp32 (background token
    last) and the selection indices (N, H, W, K). ``exact_select`` (eval)
    pins the exact candidate prefilter ('packsort' by default) and the
    one-shot eval attention; training (False) takes ``tpu.cull_prefilter``
    and the differentiable key / value streams. ``quant_params``: a frame's
    ``eval_quant_params`` for the int8 one-shot kernel (without it
    ``tpu.int8_eval`` calibrates on this call's inputs). ``dropout_rng``: a
    ``torch.Generator`` for embedder dropout (training), which takes the
    plain path."""
    meta = model_meta(cfg)
    _check_single_device(cfg)
    N, H, W, _ = rays_d.shape
    points, alive = params["points"], state["alive"]
    if rays_d.device != points.device or rays_o.device != points.device:
        raise ValueError(f"rays on {rays_d.device}, model on {points.device}")
    P = points.shape[0]
    k = meta.select_k
    eps = float(cfg.eps)

    if k >= P or k < 0:
        idx = torch.arange(P, dtype=torch.int32, device=points.device)
        idx = idx.expand(N, H * W, P)
        k = P
    else:
        impl = resolve_topk_impl(cfg, P)
        rds = rays_d.reshape(N, H * W, 3)
        if impl == "cull":
            from ..ops.tile_cull import select_topk_culled
            M = int(cfg.get_path("tpu.cull_candidates", 2048))
            blk = int(cfg.get_path("tpu.cull_block", 16))
            pf = str(cfg.get_path("tpu.cull_prefilter", "approx"))
            if exact_select:
                pf = str(cfg.get_path("tpu.cull_prefilter_eval", "packsort"))
                eblk = int(cfg.get_path("tpu.cull_block_eval", 0)) or blk
                me = cfg.get_path("tpu.cull_candidates_eval", "auto")
                M = int(me) if me != "auto" else \
                    M * max((eblk * eblk) // (blk * blk), 1)
                blk = eblk
            ee = bool(cfg.get_path("tpu.cull_early_exit", True))
            idx = torch.stack([select_topk_culled(
                points, alive, rays_o[i], rds[i].reshape(H, W, 3), k, M=M,
                block=blk, eps=eps, prefilter=pf, early_exit=ee)
                for i in range(N)])
        elif impl == "pallas":
            from ..ops.pallas_topk import pallas_select_topk
            idx = torch.stack([pallas_select_topk(points, alive, rays_o[i],
                                                  rds[i], k, eps)
                               for i in range(N)])
        else:
            chunk = int(cfg.get_path("tpu.ray_chunk", 4096))
            idx = torch.stack([select_topk(points, alive, rays_o[i], rds[i],
                                           k, eps, chunk) for i in range(N)])
    idx = idx.reshape(N, H, W, k)

    fa, qfold = _kernel_mode(cfg, k, dropout=dropout_rng is not None)
    if fa in ("streamrec", "stream"):
        # The one-shot eval kernel serves streamrec only. tpu.eval_fused:
        # false, a folded query and ``stream`` take the two-kernel eval
        # path: the training streams' forwards, nothing differentiated.
        rec_native = fa == "streamrec"
        eval_one = exact_select and _one_shot_eval(cfg, fa, qfold)
        # The int8 knobs (papr_tpu/model/papr.py:640-662): int8_eval lives
        # in the one-shot eval kernel only, int8_train in the two
        # record-native training forwards only; elsewhere on this branch one
        # warning, then the kernels without int8.
        int8_eval = bool(cfg.get_path("tpu.int8_eval", False))
        if int8_eval and exact_select and not eval_one:
            _warn_int8_ignored(
                "the one-shot eval kernel is not active here "
                f"(rec_native={rec_native}, qfold={qfold}, eval_fused="
                f"{bool(cfg.get_path('tpu.eval_fused', True))})")
        int8_train = (bool(cfg.get_path("tpu.int8_train", False))
                      and not exact_select)
        if int8_train and (not rec_native or qfold):
            _warn_int8_ignored(
                "the rec-native two-kernel path is not active here "
                f"(rec_native={rec_native}, qfold={qfold})",
                knob="int8_train")
            int8_train = False
        if eval_one:
            run = functools.partial(
                _attend_eval_kernels, int8=int8_eval,
                quant_params=quant_params if int8_eval else None)
        elif fa == "stream":
            run = _attend_stream_feat
        else:
            run = functools.partial(_attend_train_kernels, qfold=qfold,
                                    int8=int8_train)
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not exact_select):
            fused_f, attn = run(params, cfg, meta, idx, rays_o, rays_d, alive,
                                eps, policy)
        return fused_f, attn, idx
    if fa is not False:
        fused_f, attn = _attend_split(
            params, cfg, meta, idx, rays_o, rays_d, alive, eps, policy,
            use_embed_kernel=fa in (True, "embed"),
            use_score_kernel=fa in (True, "score"))
        return fused_f, attn, idx

    # Plain unfused path (papr.py:425-474), the parity oracle.
    pcf = cfg.geoms.point_feats
    pcf_dim = int(pcf.dim) if meta.use_pc_feats else 0
    record = _point_record(params, alive, meta, pcf)
    rec = record[idx.long()]                                 # (N,H,W,K,128n)
    selected = rec[..., :3]
    influ = rec[..., 3]
    sel_alive = rec[..., 4] > 0.5
    proj, perp, _, _ = point_ray_geometry(
        selected, rays_o[:, None, None, :], rays_d, eps)
    # Positions are detached in the key stream (reference
    # models/model.py:403); proj / perp keep their gradient to the points.
    k_feats = [selected.detach(), proj, perp]
    q_feats = [rays_d[..., None, :]]
    v_feats = [proj, perp]
    k_extra = q_extra = v_extra = None
    if meta.use_pc_feats:
        gathered = rec[..., 5:5 + pcf_dim]
        if pcf.use_ink:
            k_extra = [gathered]
        if pcf.use_inq:
            q_extra = [gathered]
        if pcf.use_inv:
            v_extra = [gathered]
    attn_cfg = cfg.models.attn
    ek, eq, ev = embed_kqv(params["attn"], attn_cfg, k_feats, q_feats,
                           v_feats, k_extra, q_extra, v_extra, eps=eps,
                           policy=policy, dropout_rng=dropout_rng)
    scores = score_tail(params["attn"], attn_cfg, ek, eq, policy)
    scores = scores * influ.float()
    scores = torch.where(sel_alive, scores, NEG_BIG)
    fused_f, attn = _softmax_fuse(cfg, ev, scores,
                                  float(cfg.geoms.background.constant))
    return fused_f, attn, idx


def _query_walk(params, cfg):
    """The query embedder as a kernel walk on the raw ray direction."""
    from ..ops.fused_mlp import posenc_plan, walk_from_params
    e = cfg.models.attn.embed
    _, cols = posenc_plan((3,), tuple(int(l) for l in e.q_L),
                          int(e.embed_type), float(e.pe_factor),
                          float(e.pe_mult_factor), 0)
    return walk_from_params(params["attn"]["embed_q"], e.query, cols)


def _projected_query(params, cfg, rayd_flat, policy):
    """qq (T, dm) fp32 outside the stream kernels: the fused query embedder
    (``embed_kqv`` with the key and value stacks skipped), then ``w_q`` as a
    plain matmul."""
    _, eq, _ = embed_kqv(params["attn"], cfg.models.attn, None, [rayd_flat],
                         None, eps=float(cfg.eps), policy=policy, fused=True,
                         skip_k=True, skip_v=True)
    return linear_apply(params["attn"]["w_q"], eq, policy).float()


def _record_walks(params, cfg, meta):
    """The key and value embedders as kernel walks over the point record's
    sources ([pos?, proj, perp, point features])."""
    from ..ops.fused_mlp import walk_from_params
    from ..ops.stream_attn import rec_pe_plan

    pcf = cfg.geoms.point_feats
    e = cfg.models.attn.embed

    def plan(has_pos, Ls, use_extra):
        extra = int(pcf.dim) if (meta.use_pc_feats and use_extra) else 0
        return rec_pe_plan(has_pos, tuple(int(l) for l in Ls),
                           int(e.embed_type), float(e.pe_factor),
                           float(e.pe_mult_factor), extra)

    return (walk_from_params(params["attn"]["embed_k"], e.key,
                             plan(True, e.k_L, pcf.use_ink)),
            walk_from_params(params["attn"]["embed_v"], e.value,
                             plan(False, e.v_L, pcf.use_inv)))


def _kernel_inputs(params, cfg, meta, rays_o, rays_d, alive, eps, policy,
                   qfold: bool = False):
    """Shared head of the record-native paths (papr.py:558-635): the point
    record, the flat ray origins / normalized directions / raw directions,
    ``qq`` through the fused query embedder and ``w_q`` (None with ``qfold``:
    the key stream kernel runs the query chain itself), and the key / value
    walks."""
    N, H, W, _ = rays_d.shape
    T = N * H * W
    pcf = cfg.geoms.point_feats
    record = _point_record(params, alive, meta, pcf)
    rayd_flat = rays_d.reshape(T, 3)
    rayo_flat = rays_o[:, None, :].expand(N, H * W, 3).reshape(T, 3)
    rays = normalize_vector(rayd_flat, eps=eps)
    qq = None if qfold else _projected_query(params, cfg, rayd_flat, policy)

    kwalk, vwalk = _record_walks(params, cfg, meta)
    return record, rayo_flat.contiguous(), rays, rayd_flat, qq, kwalk, vwalk


def _attend_train_kernels(params, cfg, meta, idx, rays_o, rays_d, alive,
                          eps, policy, qfold: bool = False,
                          int8: bool = False):
    """The training branch of ``_attend_kmaj`` with ``streamrec``
    (papr.py:684-713, 763-769): the k-major record gather (its gradient
    reaches points, influence scores and point features through autograd),
    the key stream, then the value stream on its attention. Autograd runs
    the backward value -> dattn -> key -> dqq -> w_q -> query embedder; with
    ``qfold`` the last three happen inside the key stream's backward. With
    ``int8`` (``tpu.int8_train``, never with ``qfold``) both forwards run
    their walks in int8; the backwards are unchanged."""
    from ..ops.stream_attn import (key_stream_scores_rec,
                                   key_stream_scores_recq,
                                   value_stream_fuse_rec)

    N, H, W, _ = rays_d.shape
    k = idx.shape[-1]
    T = N * H * W
    a = params["attn"]
    record, rayo_flat, rays, rayd_flat, qq, kwalk, vwalk = _kernel_inputs(
        params, cfg, meta, rays_o, rays_d, alive, eps, policy, qfold)
    rec = record[idx.reshape(T, k).T.long()]                 # (K, T, 128n)
    cdt = policy.compute_dtype
    tail = (cfg.models.attn.score_act, float(cfg.geoms.background.constant),
            eps, cdt)
    if qfold:
        attn = key_stream_scores_recq(
            rec, rayo_flat, rays, rayd_flat.contiguous(), kwalk,
            a["w_k"]["w"], a["w_k"]["bias"], _query_walk(params, cfg),
            a["w_q"]["w"], a["w_q"]["bias"], *tail)
    else:
        attn = key_stream_scores_rec(rec, rayo_flat, rays, qq, kwalk,
                                     a["w_k"]["w"], a["w_k"]["bias"], *tail,
                                     int8)
    fused_f = value_stream_fuse_rec(rec, rayo_flat, rays, attn, vwalk,
                                    bool(cfg.models.normalize_topk_attn), eps,
                                    cdt, int8)
    return fused_f.reshape(N, H, W, -1), attn.reshape(N, H, W, k + 1)


def _kmajor_features(params, cfg, meta, idx, rays_o, rays_d, alive, eps):
    """The k-major record gather and the per-token geometry
    (papr.py:558-589) -> (selected, proj, perp (K, T, 3), point features
    (K, T, dim) or None, influ (T, K), sel_alive (T, K) bool, rayd_flat
    (T, 3))."""
    N, H, W, _ = rays_d.shape
    k = idx.shape[-1]
    T = N * H * W
    pcf = cfg.geoms.point_feats

    record = _point_record(params, alive, meta, pcf)
    rec = record[idx.reshape(T, k).T.long()]                 # (K, T, 128n)
    selected = rec[..., :3]
    influ = rec[..., 3].T                                    # (T, K)
    sel_alive = rec[..., 4].T > 0.5

    rayd_flat = rays_d.reshape(T, 3)
    rayo_flat = rays_o[:, None, :].expand(N, H * W, 3).reshape(T, 3)
    rays = normalize_vector(rayd_flat, eps=eps)
    v = selected - rayo_flat
    t_along = (v * rays).sum(-1)
    dd = (rays * rays).sum(-1)
    proj = rays * (t_along / (dd + eps))[..., None]          # (K, T, 3)
    perp = v - proj
    feats = rec[..., 5:5 + int(pcf.dim)] if meta.use_pc_feats else None
    return selected, proj, perp, feats, influ, sel_alive, rayd_flat


def _stream_inputs(params, cfg, meta, idx, rays_o, rays_d, alive, eps):
    """Inputs of the ``stream`` kernels (papr.py:714-722, 770-778): the raw
    key features xk = [selected (detached), proj, perp, point features?] and
    value features xv = [proj, perp, point features?], each (K, T, d_raw)
    fp32, with their embedders as kernel walks, the (T, K) influence scores
    and alive mask in fp32, and the raw ray directions (T, 3). The key
    positions are detached HERE, before they enter xk: the key stream's
    backward returns all of dxk and autograd drops those columns."""
    from ..ops.fused_mlp import posenc_plan, walk_from_params

    pcf = cfg.geoms.point_feats
    e = cfg.models.attn.embed
    selected, proj, perp, feats, influ, sel_alive, rayd_flat = \
        _kmajor_features(params, cfg, meta, idx, rays_o, rays_d, alive, eps)

    def stream_input(parts, dims, Ls, use_extra, ff_params, ff_cfg):
        extra = feats is not None and bool(use_extra)
        x = torch.cat([p.float() for p in parts + ([feats] if extra else [])],
                      dim=-1)
        _, cols = posenc_plan(dims, tuple(int(l) for l in Ls),
                              int(e.embed_type), float(e.pe_factor),
                              float(e.pe_mult_factor),
                              int(pcf.dim) if extra else 0)
        return x, walk_from_params(ff_params, ff_cfg, cols)

    xk, kwalk = stream_input([selected.detach(), proj, perp], (3, 3, 3),
                             e.k_L, pcf.use_ink, params["attn"]["embed_k"],
                             e.key)
    xv, vwalk = stream_input([proj, perp], (3, 3), e.v_L, pcf.use_inv,
                             params["attn"]["embed_v"], e.value)
    return xk, kwalk, xv, vwalk, influ.float(), sel_alive.float(), rayd_flat


def _attend_stream_feat(params, cfg, meta, idx, rays_o, rays_d, alive, eps,
                        policy):
    """The ``stream`` branch of ``_attend_kmaj`` (papr.py:714-729, 770-782):
    the raw key / value features concatenated k-major, qq outside the
    kernels, then the key stream and the value stream on its attention."""
    from ..ops.stream_feat import key_stream_scores, value_stream_fuse

    N, H, W, _ = rays_d.shape
    k = idx.shape[-1]
    a = params["attn"]
    xk, kwalk, xv, vwalk, influ, sel_alive, rayd_flat = _stream_inputs(
        params, cfg, meta, idx, rays_o, rays_d, alive, eps)
    qq = _projected_query(params, cfg, rayd_flat, policy)
    cdt = policy.compute_dtype
    attn = key_stream_scores(
        xk, qq, kwalk, a["w_k"]["w"], a["w_k"]["bias"], influ, sel_alive,
        cfg.models.attn.score_act, float(cfg.geoms.background.constant), cdt)
    fused_f = value_stream_fuse(xv, attn, vwalk,
                                bool(cfg.models.normalize_topk_attn), cdt)
    return fused_f.reshape(N, H, W, -1), attn.reshape(N, H, W, k + 1)


def _split_embeddings(params, cfg, meta, idx, rays_o, rays_d, alive, eps,
                      policy, use_embed_kernel: bool):
    """Head of the split-kernel path: the k-major record gather, the
    per-token geometry and the three embedders (fused or plain) ->
    (embed_k (K, T, Dk), embed_q (T, Dq), embed_v (K, T, C), influ (T, K),
    sel_alive (T, K) bool)."""
    k = idx.shape[-1]
    pcf = cfg.geoms.point_feats
    selected, proj, perp, feats, influ, sel_alive, rayd_flat = \
        _kmajor_features(params, cfg, meta, idx, rays_o, rays_d, alive, eps)
    T = rayd_flat.shape[0]

    flat = lambda x: x.reshape(k * T, x.shape[-1])
    k_feats = [flat(selected.detach()), flat(proj), flat(perp)]
    v_feats = [flat(proj), flat(perp)]
    k_extra = v_extra = None
    if feats is not None:
        if pcf.use_ink:
            k_extra = [flat(feats)]
        if pcf.use_inv:
            v_extra = [flat(feats)]
    ek, eq, ev = embed_kqv(params["attn"], cfg.models.attn, k_feats,
                           [rayd_flat], v_feats, k_extra, None, v_extra,
                           eps=eps, policy=policy, fused=use_embed_kernel)
    return (ek.reshape(k, T, ek.shape[-1]), eq,
            ev.reshape(k, T, ev.shape[-1]), influ, sel_alive)


def _attend_split(params, cfg, meta, idx, rays_o, rays_d, alive, eps, policy,
                  use_embed_kernel: bool, use_score_kernel: bool):
    """The split-kernel branch of ``_attend_kmaj`` (papr.py:540-612,
    730-751, 783-795), in k-major token order: every (tokens, dim) tensor is
    plain 2D with token order (k, ray), so the (K*T, D) embedder outputs
    view freely as (K, T, D). The embedders run fused (``use_embed_kernel``)
    or plain, the score tail through ``fused_scores`` (``use_score_kernel``)
    or plain; the renormalize-and-fuse epilogue is plain PyTorch."""
    from ..nn.activations import build_activation
    from ..ops.fused_attn import fused_scores

    N, H, W, _ = rays_d.shape
    k = idx.shape[-1]
    T = N * H * W
    attn_cfg = cfg.models.attn
    bkg_score = float(cfg.geoms.background.constant)
    ek, eq, ev3, influ, sel_alive = _split_embeddings(
        params, cfg, meta, idx, rays_o, rays_d, alive, eps, policy,
        use_embed_kernel)

    if use_score_kernel:
        attn = fused_scores(
            ek, eq, params["attn"]["w_k"]["w"], params["attn"]["w_k"]["bias"],
            params["attn"]["w_q"]["w"], params["attn"]["w_q"]["bias"],
            influ.float(), sel_alive.float(), score_act=attn_cfg.score_act,
            bkg_score=bkg_score, compute=policy.compute_dtype)  # (T, K+1)
    else:
        kk = linear_apply(params["attn"]["w_k"], ek, policy).float()
        qq = linear_apply(params["attn"]["w_q"], eq, policy).float()
        raw = (qq[None] * kk).sum(-1) / math.sqrt(attn_cfg.d_model)
        scores = build_activation(attn_cfg.score_act)(raw).T     # (T, K)
        scores = scores * influ.float()
        scores = torch.where(sel_alive, scores, NEG_BIG)
        bkg = torch.full((T, 1), bkg_score, dtype=torch.float32,
                         device=scores.device)
        attn = torch.softmax(torch.cat([scores, bkg], dim=-1), dim=-1)

    # Renormalize + fuse (models/model.py:533-534); an all-dead ray (the
    # foreground mass exactly 0, possible only with padded slots)
    # renormalizes against 1: fused 0, the composite pure background.
    topk_attn = attn[:, :-1]
    if cfg.models.normalize_topk_attn:
        den = topk_attn.sum(-1, keepdim=True)
        topk_attn = topk_attn / torch.where(den > 0, den, torch.ones_like(den))
    fused_f = torch.einsum("tk,ktc->tc", topk_attn, ev3.float())
    return fused_f.reshape(N, H, W, -1), attn.reshape(N, H, W, k + 1)


def _attend_eval_kernels(params, cfg, meta, idx, rays_o, rays_d, alive, eps,
                         policy, int8: bool = False, quant_params=None):
    """The eval branch of ``_attend_kmaj`` (papr.py:524-682): the fused query
    embedder for ``eq``, ``w_q`` as a plain matmul, then the one-shot eval
    attention reading the point record by index; with ``int8``
    (``tpu.int8_eval``) its int8 form, on ``quant_params`` or calibrated on
    this call."""
    from ..ops.stream_attn import attend_eval_idx

    N, H, W, _ = rays_d.shape
    k = idx.shape[-1]
    T = N * H * W
    attn_cfg = cfg.models.attn
    record, rayo_flat, rays, _, qq, kwalk, vwalk = _kernel_inputs(
        params, cfg, meta, rays_o, rays_d, alive, eps, policy)
    fused_f, attn = attend_eval_idx(
        record, idx.reshape(T, k), rayo_flat, rays, qq, kwalk,
        params["attn"]["w_k"]["w"], params["attn"]["w_k"]["bias"], vwalk,
        attn_cfg.score_act, float(cfg.geoms.background.constant),
        bool(cfg.models.normalize_topk_attn), eps, policy.compute_dtype,
        int8, quant_params)
    return fused_f.reshape(N, H, W, -1), attn.reshape(N, H, W, k + 1)


def _softmax_fuse(cfg, embedv, scores, bkg_score: float):
    """Background-token softmax + foreground renormalization + fusion
    (models/model.py:526-534); an all-dead ray renormalizes against 1."""
    bkg = torch.full(scores.shape[:-1] + (1,), bkg_score, dtype=torch.float32,
                     device=scores.device)
    attn = torch.softmax(torch.cat([scores, bkg], dim=-1), dim=-1)
    topk_attn = attn[..., :-1]
    if cfg.models.normalize_topk_attn:
        den = topk_attn.sum(-1, keepdim=True)
        topk_attn = topk_attn / torch.where(den > 0, den, torch.ones_like(den))
    fused = (embedv.float() * topk_attn[..., None]).sum(-2)
    return fused, attn


def render_foreground(params: dict, cfg, fused: torch.Tensor, gamma=None,
                      beta=None, policy: Policy = F32) -> torch.Tensor:
    """Decode fused features (N, H, W, C) to RGB with the generator head."""
    g = cfg.models.renderer.generator
    if g.type == "small-unet":
        su = g.small_unet
        out = small_unet_apply(
            params["renderer"], fused, bilinear=su.bilinear, single=su.single,
            norm=su.norm, last_act=su.last_act,
            render_scale=int(su.get("render_scale", 1)),
            affine_layer=int(su.affine_layer), gamma=gamma, beta=beta,
            policy=policy)
    else:
        m = g.mlp
        out = mlp_apply(params["renderer"], policy.cast(fused),
                        act_type=m.act_type, last_act_type=m.last_act_type,
                        a=m.act_a, b=m.act_b,
                        skip_layers=tuple(m.skip_layers), policy=policy)
    return out.float()


def mapping_apply(params: dict, cfg, shading_code: torch.Tensor,
                  policy: Policy = F32):
    """Shading code -> (gamma, beta) FiLM pair (reference models/mlp.py:62-78
    and models/model.py:495-499)."""
    mm = cfg.exposure_control.mapping_mlp
    affine = mlp_apply(params["mapping_mlp"], shading_code.float(),
                       act_type=mm.act, last_act_type=mm.last_act,
                       policy=policy)
    half = affine.shape[-1] // 2
    return affine[..., :half], affine[..., half:]


def forward(params: dict, state: dict, cfg, rays_o, rays_d, c2w=None,
            shading_code=None, policy: Policy = F32,
            dropout_rng=None) -> torch.Tensor:
    """Full training forward -> RGB (N, H, W, 3) fp32, differentiable in
    the parameters (reference models/model.py:494-560). ``dropout_rng``: a
    ``torch.Generator`` that turns embedder dropout on (``dropout_ff > 0``;
    the plain path)."""
    meta = model_meta(cfg)
    gamma = beta = None
    if shading_code is not None and meta.use_mapping_mlp:
        gamma, beta = mapping_apply(params, cfg, shading_code, policy)
    fused, attn, _ = _attend(params, state, cfg, rays_o, rays_d, policy,
                             exact_select=False, dropout_rng=dropout_rng)
    bkg_attn = attn[..., -1:]
    if meta.use_renderer:
        foreground = render_foreground(params, cfg, fused, gamma, beta, policy)
    else:
        foreground = fused
    return composite_background(cfg, params, foreground, bkg_attn)


def ray_margin(params: dict, state: dict, cfg, rays_o,
               rays_d) -> torch.Tensor:
    """Per ray of ``forward`` (N * H * W, in its order): the smallest
    ``fused_mlp.walk_relu_margin`` over the walks the mode's kernels run for
    it (the query embedder or the folded query walk; the key and value walks
    over its K tokens, record-native, on feature tensors or as embedder
    stacks), on the inputs those kernels are given in one forward under the
    config's policy. A ray whose margin is small has a relu input that two
    correct forwards may round to opposite sides of 0."""
    from ..ops import fused_mlp as fm
    from ..ops import stream_attn as sa
    from ..ops import stream_feat as sf
    seen, real = [], {}

    def record(mod, name):
        real[(mod, name)] = getattr(mod, name)

        def fn(*args, **kwargs):
            seen.append((name, args))
            return real[(mod, name)](*args, **kwargs)
        setattr(mod, name, fn)

    for mod, name in ((fm, "fused_mlp"), (sa, "key_stream_fwd"),
                      (sa, "key_stream_q_fwd"), (sa, "value_stream_fwd"),
                      (sf, "key_stream_feat_fwd"),
                      (sf, "value_stream_feat_fwd")):
        record(mod, name)
    try:
        with torch.no_grad():
            forward(params, state, cfg, rays_o, rays_d,
                    policy=policy_from_config(cfg))
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
    eps = float(cfg.eps)
    T = rays_d.reshape(-1, 3).shape[0]
    margin = torch.full((T,), float("inf"), device=rays_d.device)
    rows = lambda x, w: fm.walk_relu_margin(fm.encode_plain(x, w.cols), w)
    for name, a in seen:
        if name == "fused_mlp":          # ray-major rows: a ray's tokens
            m = rows(a[0], a[1]).reshape(T, -1).amin(dim=1)
        elif name in ("key_stream_feat_fwd", "value_stream_feat_fwd"):
            K, _, d = a[0].shape         # k-major (K, T, d) features
            m = rows(a[0].reshape(K * T, d), a[2]).reshape(K, T).amin(dim=0)
        else:                            # record-native (K, T, rp) streams
            m = sa.rec_relu_margin(a[0], a[1], a[2], a[4], eps)
            if name == "key_stream_q_fwd":
                m = torch.minimum(m, rows(a[3], a[7]))
        margin = torch.minimum(margin, m)
    return margin


def evaluate(params: dict, state: dict, cfg, rays_o, rays_d,
             policy: Policy = F32, with_selected: bool = False,
             quant_params=None):
    """Attention half only, for tiled full-image rendering (reference
    models/model.py:462-492): fused (N, H, W, 1, C), attention
    (N, H, W, K+1, 1) and, with ``with_selected``, the selected points.
    ``quant_params``: the frame's ``eval_quant_params`` (``tpu.int8_eval``
    in a tiled render; without it the int8 kernel calibrates per call)."""
    fused, attn, idx = _attend(params, state, cfg, rays_o, rays_d, policy,
                               quant_params=quant_params)
    out = (fused[..., None, :], attn[..., None])
    if with_selected:
        return out + (params["points"][idx.long()],)
    return out


@torch.no_grad()
def eval_quant_params(params: dict, state: dict, cfg, rays_o, rays_sample,
                      policy: Policy = F32):
    """Frame-level int8 calibration for ``tpu.int8_eval`` in tiled renders
    (``papr_tpu/model/papr.py eval_quant_params``): ``walk_amax`` +
    ``quantize_walk`` once per frame, on ``S = min(1024, P, n_rays)``
    evenly strided RAW point records as one K = 1 slot, paired with as many
    strided, normalized rays of the frame and the camera origin. Raw points
    are farther from the rays than selected ones, so the amax bounds the
    per-tile one from above. The tile loop here is host code: calibrating
    per tile would repeat ~40 small launches for every tile.

    rays_o: (3,) or (1, 3); rays_sample: (S, 3), need not be normalized.
    Returns (key WalkQuant, value WalkQuant) as a ``FrameQuant`` for
    ``evaluate(..., quant_params=)``, or None when this config's eval does
    not take the one-shot int8 kernel."""
    from ..ops.fused_mlp import FrameQuant
    from ..ops.stream_attn import quantize_walk, walk_amax

    meta = model_meta(cfg)
    P = params["points"].shape[0]
    k = meta.select_k
    fa, qfold = _kernel_mode(cfg, P if (k >= P or k < 0) else k)
    if not _one_shot_eval(cfg, fa, qfold):
        return None
    eval_quant_params.calls += 1
    eps = float(cfg.eps)
    record = _point_record(params, state["alive"], meta,
                           cfg.geoms.point_feats)
    rays_sample = rays_sample.reshape(-1, 3)
    n = rays_sample.shape[0]
    S = int(min(1024, P, n))
    pick = lambda m: torch.arange(S, device=record.device) * max(1, m // S)
    rec_cal = record[pick(P)][None]                          # (1, S, rp)
    rays = normalize_vector(rays_sample[pick(n)], eps=eps)
    rayo = rays_o.reshape(1, 3).expand(S, 3)
    return FrameQuant(
        quantize_walk(w.ws, walk_amax(rec_cal, rayo, rays, w, eps,
                                      policy.compute_dtype))
        for w in _record_walks(params, cfg, meta))


eval_quant_params.calls = 0


def composite_background(cfg, params, foreground, bkg_attn):
    """Eval-time compositing (reference train.py:74-82)."""
    if cfg.models.normalize_topk_attn:
        return foreground * (1 - bkg_attn) + params["bkg_feats"][0] * bkg_attn
    return foreground + params["bkg_feats"][0] * bkg_attn
