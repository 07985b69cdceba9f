"""The port's parameters <-> the reference's torch state_dict
(``papr_tpu/model/torch_convert.py``).

Two jobs:
  1. import pretrained reference checkpoints (``model.pth`` /
     ``model_<step>.pth``, reference models/model.py:562-641) into the
     padded parameter tree;
  2. export the port's parameters in that layout, so a model trained here
     loads in the reference and in the JAX package.

Key layout (reference module names):
  points, points_influ_scores, pc_feats, bkg_feats
  proximity_attn.embed.embed_{k,q,v}.{innorm,outnorm}.{a_2,b_2}
  proximity_attn.embed.embed_{k,q,v}.mlp.model.<1+2i>.{weight,bias}
  proximity_attn.attention_layer.w_{k,q}.{weight,bias}
  renderer.inc.double_conv.0.*, renderer.down{1,2}.maxpool_conv.1.double_conv.*,
  renderer.up{1,2}.up.*, renderer.up{1,2}.conv.double_conv.*, renderer.outc.conv.*
  mapping_mlp.model.model.<1+2i>.{weight,bias}

Tensor layout transforms: Linear (out, in) both sides; Conv2d torch OIHW <->
ours HWIO; ConvTranspose2d torch (in, out, kh, kw) <-> ours (kh, kw, in, out).
Tensors stay torch tensors throughout: the state dict comes out on the
model's device, and an imported one goes onto it.
"""

from __future__ import annotations

import torch

from .papr import model_meta

CODE_KEYS = ("train_shading_codes", "eval_shading_codes")


def _t(x) -> torch.Tensor:
    return x.detach().clone()


def _mlp_entries(prefix: str, mlp_params: dict, out: dict):
    for i, layer in enumerate(mlp_params["layers"]):
        base = f"{prefix}.model.{1 + 2 * i}"
        if "v" in layer:
            out[f"{base}.weight_v"] = _t(layer["v"])
            out[f"{base}.weight_g"] = _t(layer["g"])
        else:
            out[f"{base}.weight"] = _t(layer["w"])
        if "bias" in layer:
            out[f"{base}.bias"] = _t(layer["bias"])


def _ff_entries(prefix: str, ff_params: dict, out: dict):
    if "innorm" in ff_params:
        out[f"{prefix}.innorm.a_2"] = _t(ff_params["innorm"]["a"])
        out[f"{prefix}.innorm.b_2"] = _t(ff_params["innorm"]["b"])
        out[f"{prefix}.outnorm.a_2"] = _t(ff_params["outnorm"]["a"])
        out[f"{prefix}.outnorm.b_2"] = _t(ff_params["outnorm"]["b"])
    _mlp_entries(f"{prefix}.mlp", ff_params["mlp"], out)


def _conv_entries(prefix: str, conv_params: dict, out: dict):
    out[f"{prefix}.weight"] = conv_params["w"].detach().permute(
        3, 2, 0, 1).contiguous()
    out[f"{prefix}.bias"] = _t(conv_params["b"])


def _convT_entries(prefix: str, conv_params: dict, out: dict):
    out[f"{prefix}.weight"] = conv_params["w"].detach().permute(
        2, 3, 0, 1).contiguous()
    out[f"{prefix}.bias"] = _t(conv_params["b"])


def _c2_index(cfg) -> int:
    # DoubleConv's second conv sits at Sequential index 2 with norm='none'
    # and 3 with instance/batch norm (reference models/unet.py:42-79).
    return 2 if cfg.models.renderer.generator.small_unet.norm == "none" else 3


def to_torch_state_dict(params: dict, state: dict, cfg) -> dict:
    """Export live (unpadded) tensors under the reference's key names."""
    meta = model_meta(cfg)
    alive = state["alive"].bool()
    out: dict = {
        # select_k is a registered buffer in the reference (models/model.py:34)
        "select_k": torch.tensor(int(cfg.geoms.points.select_k),
                                 dtype=torch.int32),
        "points": _t(params["points"][alive]),
        "points_influ_scores": _t(params["points_influ_scores"][alive]),
        "bkg_feats": _t(params["bkg_feats"]),
    }
    if meta.use_pc_feats:
        out["pc_feats"] = _t(params["pc_feats"][alive])

    attn = params["attn"]
    for name in ("k", "q", "v"):
        _ff_entries(f"proximity_attn.embed.embed_{name}", attn[f"embed_{name}"],
                    out)
    for name in ("k", "q"):
        out[f"proximity_attn.attention_layer.w_{name}.weight"] = _t(
            attn[f"w_{name}"]["w"])
        out[f"proximity_attn.attention_layer.w_{name}.bias"] = _t(
            attn[f"w_{name}"]["bias"])

    if meta.use_renderer and cfg.models.renderer.generator.type == "small-unet":
        r = params["renderer"]
        c2i = _c2_index(cfg)
        _conv_entries("renderer.inc.double_conv.0", r["inc"]["c1"], out)
        for name in ("down1", "down2"):
            blk = r[name]
            _conv_entries(f"renderer.{name}.maxpool_conv.1.double_conv.0",
                          blk["c1"], out)
            if "c2" in blk:
                _conv_entries(
                    f"renderer.{name}.maxpool_conv.1.double_conv.{c2i}",
                    blk["c2"], out)
        for name in ("up1", "up2"):
            blk = r[name]
            if "up" in blk:
                _convT_entries(f"renderer.{name}.up", blk["up"], out)
            _conv_entries(f"renderer.{name}.conv.double_conv.0",
                          blk["conv"]["c1"], out)
            if "c2" in blk["conv"]:
                _conv_entries(f"renderer.{name}.conv.double_conv.{c2i}",
                              blk["conv"]["c2"], out)
        if "up3" in r:
            if "up" in r["up3"]:
                _convT_entries("renderer.up3.up", r["up3"]["up"], out)
            _conv_entries("renderer.up3.conv.double_conv.0",
                          r["up3"]["conv"]["c1"], out)
            _conv_entries(f"renderer.up3.conv.double_conv.{c2i}",
                          r["up3"]["conv"]["c2"], out)
        _conv_entries("renderer.outc.conv", r["outc"], out)
    elif meta.use_renderer:
        _mlp_entries("renderer.mlp", params["renderer"], out)

    if meta.use_mapping_mlp and "mapping_mlp" in params:
        _mlp_entries("mapping_mlp.model", params["mapping_mlp"], out)
    return out


# ------------------------------------------------------------------ import --

class _Loader:
    """Copies state-dict entries onto the model's device in the dtype of the
    leaf they replace (fp32 parameters)."""

    def __init__(self, sd: dict, device):
        self.sd, self.device = sd, device

    def has(self, key: str) -> bool:
        return key in self.sd

    def get(self, key: str, like: torch.Tensor | None = None,
            perm=None) -> torch.Tensor:
        t = torch.as_tensor(self.sd[key])
        if perm is not None:
            t = t.permute(*perm)
        dtype = like.dtype if like is not None else torch.float32
        return t.to(device=self.device, dtype=dtype, copy=True).contiguous()


def _set_linear(layer: dict, ld: _Loader, base: str):
    if not (ld.has(f"{base}.weight") or ld.has(f"{base}.weight_v")):
        return  # excluded or absent: keep the fresh init
    if ld.has(f"{base}.weight_v"):
        layer["v"] = ld.get(f"{base}.weight_v", layer.get("v"))
        layer["g"] = ld.get(f"{base}.weight_g", layer.get("g"))
    else:
        layer["w"] = ld.get(f"{base}.weight", layer.get("w"))
    if ld.has(f"{base}.bias"):
        layer["bias"] = ld.get(f"{base}.bias", layer.get("bias"))


def _set_mlp(mlp_params: dict, ld: _Loader, prefix: str):
    for i, layer in enumerate(mlp_params["layers"]):
        _set_linear(layer, ld, f"{prefix}.model.{1 + 2 * i}")


def _set_ff(ff_params: dict, ld: _Loader, prefix: str):
    if "innorm" in ff_params and ld.has(f"{prefix}.innorm.a_2"):
        for norm in ("innorm", "outnorm"):
            ff_params[norm]["a"] = ld.get(f"{prefix}.{norm}.a_2",
                                          ff_params[norm]["a"])
            ff_params[norm]["b"] = ld.get(f"{prefix}.{norm}.b_2",
                                          ff_params[norm]["b"])
    _set_mlp(ff_params["mlp"], ld, f"{prefix}.mlp")


def _set_conv(conv_params: dict, ld: _Loader, prefix: str,
              transpose: bool = False):
    if not ld.has(f"{prefix}.weight"):
        return  # excluded or absent: keep the fresh init
    # ConvTranspose2d (in, out, kh, kw) -> (kh, kw, in, out); Conv2d OIHW ->
    # HWIO.
    conv_params["w"] = ld.get(f"{prefix}.weight", conv_params["w"],
                              (2, 3, 0, 1) if transpose else (2, 3, 1, 0))
    conv_params["b"] = ld.get(f"{prefix}.bias", conv_params["b"])


def from_torch_state_dict(params: dict, state: dict, cfg, sd: dict,
                          exclude_keys=()):
    """Load a reference state_dict (tensor- or numpy-valued) into a copy of
    a fresh parameter tree, on its device.

    Shape-polymorphic arrays (points / scores / pc_feats; reference
    models/model.py:617-641) are padded to the static size (points parked at
    1e8) and the alive mask is rebuilt from the loaded live count.
    ``exclude_keys`` substrings skip matching entries (reference
    load_my_state_dict / training.exclude_keys). Returns (params, state,
    extras): extras holds the shading codes the state dict carries."""
    meta = model_meta(cfg)
    exclude_keys = tuple(exclude_keys) or tuple(
        cfg.get_path("training.exclude_keys", []) or [])
    sd = {k: v for k, v in sd.items()
          if not any(e in k for e in exclude_keys)}
    P = meta.pad_num_pts
    if "points" not in sd:
        raise KeyError("state_dict has no 'points' (did exclude_keys drop it?)")
    dev = params["points"].device
    ld = _Loader(sd, dev)
    n_live = int(torch.as_tensor(sd["points"]).shape[0])
    assert n_live <= P, (n_live, P)

    def pad(key, fill=0.0):
        arr = ld.get(key)
        out = torch.full((P,) + tuple(arr.shape[1:]), fill,
                         dtype=torch.float32, device=dev)
        out[:n_live] = arr
        return out

    params = _copy_tree(params)
    params["points"] = pad("points", 1e8)
    params["points_influ_scores"] = pad("points_influ_scores")
    if meta.use_pc_feats and "pc_feats" in sd:
        params["pc_feats"] = pad("pc_feats")
    if "bkg_feats" in sd:
        params["bkg_feats"] = ld.get("bkg_feats", params["bkg_feats"])

    attn = params["attn"]
    for name in ("k", "q", "v"):
        _set_ff(attn[f"embed_{name}"], ld, f"proximity_attn.embed.embed_{name}")
    for name in ("k", "q"):
        _set_linear(attn[f"w_{name}"], ld,
                    f"proximity_attn.attention_layer.w_{name}")

    if meta.use_renderer and cfg.models.renderer.generator.type == "small-unet":
        r = params["renderer"]
        c2i = _c2_index(cfg)
        _set_conv(r["inc"]["c1"], ld, "renderer.inc.double_conv.0")
        for name in ("down1", "down2"):
            _set_conv(r[name]["c1"], ld,
                      f"renderer.{name}.maxpool_conv.1.double_conv.0")
            if "c2" in r[name]:
                _set_conv(r[name]["c2"], ld,
                          f"renderer.{name}.maxpool_conv.1.double_conv.{c2i}")
        for name in ("up1", "up2"):
            if "up" in r[name]:
                _set_conv(r[name]["up"], ld, f"renderer.{name}.up",
                          transpose=True)
            _set_conv(r[name]["conv"]["c1"], ld,
                      f"renderer.{name}.conv.double_conv.0")
            if "c2" in r[name]["conv"]:
                _set_conv(r[name]["conv"]["c2"], ld,
                          f"renderer.{name}.conv.double_conv.{c2i}")
        if "up3" in r:
            if "up" in r["up3"]:
                _set_conv(r["up3"]["up"], ld, "renderer.up3.up",
                          transpose=True)
            _set_conv(r["up3"]["conv"]["c1"], ld,
                      "renderer.up3.conv.double_conv.0")
            _set_conv(r["up3"]["conv"]["c2"], ld,
                      f"renderer.up3.conv.double_conv.{c2i}")
        _set_conv(r["outc"], ld, "renderer.outc.conv")
    elif meta.use_renderer:
        _set_mlp(params["renderer"], ld, "renderer.mlp")

    if meta.use_mapping_mlp and "mapping_mlp" in params:
        _set_mlp(params["mapping_mlp"], ld, "mapping_mlp.model")

    alive = torch.zeros((P,), dtype=torch.bool, device=dev)
    alive[:n_live] = True
    state = dict(state)
    state["alive"] = alive
    extras = {key: ld.get(key) for key in CODE_KEYS if key in sd}
    return params, state, extras


def _copy_tree(tree):
    """The dict / list structure copied, the tensors shared: entries set on
    the copy leave the caller's tree as it was."""
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_tree(v) for v in tree]
    return tree


def load_torch_checkpoint(path: str):
    """Read a reference model.pth ({step: state_dict}) or a raw state_dict
    -> (step, state_dict of CPU tensors)."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and all(isinstance(k, str) and k.isdigit()
                                     for k in obj):
        step, sd = next(iter(obj.items()))
        return int(step), dict(sd)
    return 0, dict(obj)

