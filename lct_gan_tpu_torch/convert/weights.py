"""Weight bridge: JAX-package generator params -> the port's state_dict, and
`load_enhancer` for both committed weight formats.

The port's module names are the reference state_dict's, so a JAX param
tree converts with the reference exporter's layout rules (the port's own
copy of `lct_gan_tpu/convert/torch_export.py:41-114,199-212`):

  HWIO conv kernel [kh, kw, in, out]   -> Conv2d [out, in, kh, kw]
  HWIO pre-flipped deconv kernel       -> ConvTranspose2d [in, out, kh, kw]
  Dense kernel [in, out]               -> Linear [out, in]
  GRU w_ih[dir, group] = [I, 3H]       -> gru{g}.weight_ih_l0{_reverse} [3H, I]
  MHA in_proj_kernel [E, 3E]           -> in_proj_weight [3E, E]
  LayerNorm scale / bias               -> weight / bias

plus the `stft.window` periodic Hann buffer; and, for the discriminators
(`torch_export.py:117-197`):

  WNConv v (k..., in, out), g [out]     -> weight_v [out, in, k...],
                                           weight_g [out, 1, ...]
  SNConv kernel, spectral u / v         -> weight_orig [out, in, k...],
                                           weight_u, weight_v (v permuted
                                           from (k..., in) to (in, k...))

The generator `.npz` format
(flat '/'-joined keys with an embedded `__meta_json__`) is read with numpy,
as `lct_gan_tpu/train/checkpoint.py:85-146` writes it.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from lct_gan_tpu_torch.models.generator import (LCTGeneratorConfig,
                                                LctEnhancer)
from lct_gan_tpu_torch.utils.device import resolve_device

__all__ = ["jax_params_to_state_dict", "jax_disc_params_to_state_dict",
           "read_npz_params", "load_enhancer"]

_NPZ_META_KEY = "__meta_json__"


def _f32(x: Any) -> np.ndarray:
    """A writable, contiguous float32 copy (torch.from_numpy shares it)."""
    return np.array(x, dtype=np.float32, order="C")


def _conv2d(out, prefix, p):
    out[f"{prefix}.weight"] = _f32(np.transpose(p["kernel"], (3, 2, 0, 1)))
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _conv_transpose2d(out, prefix, p):
    k = np.asarray(p["kernel"])[::-1, ::-1]  # un-flip kh, kw
    out[f"{prefix}.weight"] = _f32(np.transpose(k, (2, 3, 0, 1)))
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _dense(out, prefix, p):
    out[f"{prefix}.weight"] = _f32(np.asarray(p["kernel"]).T)
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _layernorm(out, prefix, p):
    out[f"{prefix}.weight"] = _f32(p["scale"])
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _mha(out, prefix, p):
    out[f"{prefix}.in_proj_weight"] = _f32(np.asarray(p["in_proj_kernel"]).T)
    out[f"{prefix}.in_proj_bias"] = _f32(p["in_proj_bias"])
    out[f"{prefix}.out_proj.weight"] = _f32(np.asarray(p["out_proj_kernel"]).T)
    out[f"{prefix}.out_proj.bias"] = _f32(p["out_proj_bias"])


def _grouped_gru(out, prefix, p):
    w_ih, w_hh = np.asarray(p["w_ih"]), np.asarray(p["w_hh"])
    b_ih, b_hh = np.asarray(p["b_ih"]), np.asarray(p["b_hh"])
    dirs, groups = w_ih.shape[:2]
    for d in range(dirs):
        sfx = "_reverse" if d == 1 else ""
        for g in range(groups):
            pfx = f"{prefix}.gru{g + 1}"
            out[f"{pfx}.weight_ih_l0{sfx}"] = _f32(w_ih[d, g].T)
            out[f"{pfx}.weight_hh_l0{sfx}"] = _f32(w_hh[d, g].T)
            out[f"{pfx}.bias_ih_l0{sfx}"] = _f32(b_ih[d, g])
            out[f"{pfx}.bias_hh_l0{sfx}"] = _f32(b_hh[d, g])


def _wn_conv(out, prefix, p, conv1d):
    v = np.asarray(p["v"])
    perm, g_shape = ((2, 1, 0), (-1, 1, 1)) if conv1d else \
        ((3, 2, 0, 1), (-1, 1, 1, 1))
    out[f"{prefix}.weight_v"] = _f32(np.transpose(v, perm))
    out[f"{prefix}.weight_g"] = _f32(np.asarray(p["g"]).reshape(g_shape))
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _sn_conv(out, prefix, p, spectral, conv1d):
    k = np.asarray(p["kernel"])
    v = np.asarray(spectral["v"])
    if conv1d:
        ksz, in_g, _ = k.shape
        out[f"{prefix}.weight_orig"] = _f32(np.transpose(k, (2, 1, 0)))
        v_t = v.reshape(ksz, in_g).transpose(1, 0).reshape(-1)
    else:
        kh, kw, in_g, _ = k.shape
        out[f"{prefix}.weight_orig"] = _f32(np.transpose(k, (3, 2, 0, 1)))
        v_t = v.reshape(kh, kw, in_g).transpose(2, 0, 1).reshape(-1)
    out[f"{prefix}.weight_u"] = _f32(spectral["u"])
    out[f"{prefix}.weight_v"] = _f32(v_t)
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _disc_state_dict(params, spectral, subs, conv_names, conv1d):
    out: Dict[str, np.ndarray] = {}
    for i, sub_name in enumerate(subs):
        sub = params[sub_name]
        ssub = (spectral or {}).get(sub_name)
        for j, name in enumerate(conv_names):
            key = (f"discriminators.{i}.conv_post" if name == "conv_post"
                   else f"discriminators.{i}.convs.{j}")
            if ssub is not None:
                _sn_conv(out, key, sub[name], ssub[name], conv1d)
            else:
                _wn_conv(out, key, sub[name], conv1d)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def jax_disc_params_to_state_dict(
        mpd_params: Mapping[str, Any], msd_params: Mapping[str, Any],
        spectral: Optional[Mapping[str, Any]] = None,
        periods=(2, 3, 5, 7, 11), num_scales: int = 3
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """JAX-package MPD and MSD param trees (and, with spectral norm, the
    'spectral' tree {"mpd": ..., "msd": ...}) -> the port's
    (MultiPeriodDiscriminator, MultiScaleDiscriminator) state_dicts, the
    layouts of `export_mpd_state_dict` / `export_msd_state_dict`."""
    spectral = spectral or {}
    mpd = _disc_state_dict(
        mpd_params, spectral.get("mpd"), [f"disc_p{p}" for p in periods],
        [f"conv{j}" for j in range(5)] + ["conv_post"], conv1d=False)
    msd = _disc_state_dict(
        msd_params, spectral.get("msd"),
        [f"disc_s{i}" for i in range(num_scales)],
        [f"conv{j}" for j in range(6)] + ["conv_post"], conv1d=True)
    return mpd, msd


def _hann_periodic(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(
        2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def jax_params_to_state_dict(params: Mapping[str, Any], n_fft: int = 512
                             ) -> Dict[str, torch.Tensor]:
    """A JAX-package LctEnhancer param tree (nested dicts of arrays, with or
    without the top-level 'gen') -> the port's LctEnhancer state_dict."""
    gen = params["gen"] if "gen" in params else params
    out: Dict[str, np.ndarray] = {}
    for name in ("conv1", "conv2", "conv3", "skip2", "skip3", "skip4"):
        _conv2d(out, f"gen.{name}", gen[name])
    _layernorm(out, "gen.layernorm", gen["layernorm"])
    for name in ("GRUf1", "GRUt1", "GRUf2"):
        blk = gen[name]
        _layernorm(out, f"gen.{name}.layernorm1", blk["layernorm1"])
        _layernorm(out, f"gen.{name}.layernorm2", blk["layernorm2"])
        _grouped_gru(out, f"gen.{name}", blk["gru"])
        _mha(out, f"gen.{name}.attn", blk["attn"])
        _dense(out, f"gen.{name}.lin", blk["lin"])
    for name in ("deconv2", "deconv3", "deconv4"):
        _conv_transpose2d(out, f"gen.{name}", gen[name])
    out["stft.window"] = _hann_periodic(n_fft)
    return {k: torch.from_numpy(v) for k, v in out.items()}


def read_npz_params(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A generator .npz -> (nested param dict, embedded meta or {})."""
    nested: Dict[str, Any] = {}
    meta: Dict[str, Any] = {}
    with np.load(path) as z:
        for key in z.files:
            if key == _NPZ_META_KEY:
                meta = json.loads(bytes(z[key]).decode("utf-8"))
                continue
            node = nested
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return nested, meta


def load_enhancer(path: str, device="cuda", *,
                  compress_c: Optional[float] = None,
                  max_time_context: Optional[int] = None,
                  precise: bool = False) -> LctEnhancer:
    """Build an LctEnhancer with the weights of `path` on `device`, in eval
    mode. Accepts a generator `.npz` (its embedded train_cfg supplies
    compress_c and max_time_context) or a reference-format `.pt`
    ({'enhancer': state_dict, 'args': {...}}), loaded with strict=True.
    Explicit compress_c / max_time_context override the file's, with a
    warning when they differ from its training value (they change outputs
    without changing any parameter shape, as the JAX CLI warns:
    `infer.py:113-132`)."""
    dev = resolve_device(device)
    if path.endswith(".npz") and os.path.isfile(path):
        params, meta = read_npz_params(path)
        state = jax_params_to_state_dict(params)
        saved = meta.get("train_cfg", {})
    elif os.path.isfile(path):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        state = ckpt["enhancer"]
        saved = ckpt.get("args", {}) or {}
    else:
        raise FileNotFoundError(f"no weight file at {path}")
    if compress_c is None:
        compress_c = float(saved.get("compress_c", 0.3))
    elif ("compress_c" in saved
          and compress_c != float(saved["compress_c"])):
        warnings.warn(f"compress_c={compress_c} differs from the "
                      f"checkpoint's training value {saved['compress_c']}",
                      stacklevel=2)
    if max_time_context is None:
        if saved.get("max_time_context") is not None:
            max_time_context = int(saved["max_time_context"])
    elif saved and max_time_context != saved.get("max_time_context"):
        warnings.warn(f"max_time_context={max_time_context} differs from "
                      f"the checkpoint's training value "
                      f"{saved.get('max_time_context')}", stacklevel=2)
    enhancer = LctEnhancer(
        gen_cfg=LCTGeneratorConfig(max_time_context=max_time_context),
        c=compress_c, precise=precise)
    enhancer.load_state_dict(state, strict=True)
    return enhancer.to(dev).eval()
