"""Weights carried into the port (numpy only; no jax import).

The port's AR and NAR modules use the reference state-dict names, so a
reference checkpoint loads with ``load_state_dict(strict=True)`` after one
change: the AR's wq/wk rows are stored interleaved per head in reference
checkpoints, and the port keeps them half-split (``ops/rope.py``), so
``codeclm_port_state_dict`` permutes them once at load.

Parameters of the JAX package reach the port through
``codeclm_reference_state_dict`` / ``nar_reference_state_dict``, numpy
re-implementations of its ``convert_codeclm_back`` / ``convert_nar_back``.
Encodec and Vocos take the JAX pytree directly (``encodec_from_pytree``,
``vocos_from_pytree``).

A NAR pytree quantized by the JAX package's ``quantize_nar`` (per-row
``{"q", "s"}`` leaves, or ``{"q", "sg"}`` with ``w_gsize``) converts to a
state dict with ``<weight>.q`` / ``<weight>.s`` (or ``<weight>.sg``, (G, N))
entries, which ``load_nar`` loads into a W8A8 model.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quant import QuantWeight, set_weight
from .ar import CodecLM, CodecLMConfig
from .nar import ResidualTransformer, ResidualTransformerConfig


def _np(t):
    """Tensor or array-like -> numpy; fp16 (as stored on disk) -> f32."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == np.float16 else a


def _rope_perm(out_dim: int, head_dim: int):
    perm = np.arange(out_dim).reshape(-1, head_dim)
    return np.concatenate([perm[:, 0::2], perm[:, 1::2]], axis=1).reshape(-1)


def permute_rope_rows(w, head_dim: int):
    """Per-head output rows [0, 2, ..., 1, 3, ...]: interleaved -> half-split."""
    return w[_rope_perm(w.shape[0], head_dim)]


def unpermute_rope_rows(w, head_dim: int):
    """Inverse of ``permute_rope_rows``."""
    inv = np.argsort(_rope_perm(w.shape[0], head_dim))
    return w[inv]


def infer_codeclm_config(sd, n_vocab: int | None = None) -> CodecLMConfig:
    """CodecLMConfig from reference state-dict shapes (head_dim is 64, as in
    every released checkpoint)."""
    nv, dim = sd["embed.weight"].shape
    head_dim = 64

    def count(prefix, pos):
        return 1 + max(int(k.split(".")[pos]) for k in sd if k.startswith(prefix))

    return CodecLMConfig(
        n_vocab=int(n_vocab or nv), dim=int(dim),
        n_heads=int(sd["ar.layers.0.attention.wq.weight"].shape[0] // head_dim),
        n_kv_heads=int(sd["ar.layers.0.attention.wk.weight"].shape[0] // head_dim),
        head_dim=head_dim, n_layers=count("ar.layers.", 2),
        hidden_dim=int(sd["ar.layers.0.feed_forward.w1.weight"].shape[0]),
        n_spk_layers=count("spk_encoder.layers.", 2),
        spk_hidden_dim=int(sd["spk_encoder.layers.0.activation.W.weight"].shape[0]),
        codebook_size=int(sd["ref_chunked_emb.embs.0.weight"].shape[0]),
        n_codebooks=sum(1 for k in sd if k.startswith("ref_chunked_emb.embs.")))


def infer_nar_config(sd, nhead: int = 16) -> ResidualTransformerConfig:
    """ResidualTransformerConfig from reference state-dict shapes (nhead is
    the released 16)."""
    n_text, dim = sd["text_embed.weight"].shape

    def count(prefix, pos):
        return 1 + max(int(k.split(".")[pos]) for k in sd if k.startswith(prefix))

    return ResidualTransformerConfig(
        n_text_vocab=int(n_text), n_quant=int(sd["residual_decoder.0.1.weight"].shape[0]),
        dim=int(dim), nhead=nhead, enc_layers=count("tfm.encoder.layers.", 3),
        dec_layers=count("tfm.decoder.layers.", 3),
        n_spk_layers=count("spk_encoder.layers.", 2),
        pred_quant_levels=sum(1 for k in sd if k.startswith("residual_decoder.")
                              and k.endswith(".1.weight")),
        t_emb_dim=int(sd["timestep_encoder_emb.0.weight"].shape[1]),
        hidden_dim=int(sd["tfm.encoder.layers.0.activation.W.weight"].shape[0]))


def mla_rope_rows(cfg: CodecLMConfig):
    """(wq's, wkv_a's) row orders of latent attention that take each head's
    interleaved ``q_pe`` rows and the shared ``k_pe`` rows to half-split."""
    rope, r = cfg.qk_rope_head_dim, cfg.kv_lora_rank
    q = np.arange(cfg.n_heads * cfg.head_dim).reshape(cfg.n_heads, cfg.head_dim)
    q[:, cfg.qk_nope_head_dim:] = q[:, cfg.qk_nope_head_dim:][:, _rope_perm(rope, rope)]
    return q.reshape(-1), np.concatenate([np.arange(r), r + _rope_perm(rope, rope)])


def codeclm_port_state_dict(sd, cfg: CodecLMConfig) -> dict:
    """Reference CodecLM state dict -> the port's (wq/wk rows half-split;
    latent attention's rope rows of wq and wkv_a likewise)."""
    out = {k: _np(v) for k, v in sd.items()}
    if cfg.attention == "mla":
        q_rows, kv_rows = mla_rope_rows(cfg)
        for i in range(cfg.n_layers):
            pre = f"ar.layers.{i}.attention."
            out[pre + "wq.weight"] = out[pre + "wq.weight"][q_rows]
            out[pre + "wkv_a.weight"] = out[pre + "wkv_a.weight"][kv_rows]
        return out
    for i in range(cfg.n_layers):
        for w in ("wq", "wk"):
            key = f"ar.layers.{i}.attention.{w}.weight"
            out[key] = permute_rope_rows(out[key], cfg.head_dim)
    return out


def _load(model, sd, dtype, device, trainable: bool = False):
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    model = model.to(device=device, dtype=dtype)
    return model.requires_grad_(True).train() if trainable else model.requires_grad_(False).eval()


def load_codeclm(sd, cfg: CodecLMConfig, dtype=torch.float32, device="cpu",
                 trainable: bool = False, remat: bool | None = None) -> CodecLM:
    """A CodecLM holding a reference-layout state dict, frozen for inference
    (``trainable``: with gradients, for ``train.py``; ``remat``: the
    model's per-layer rematerialization)."""
    return _load(CodecLM(cfg, remat), codeclm_port_state_dict(sd, cfg), dtype, device,
                 trainable)


def load_nar(sd, cfg: ResidualTransformerConfig, dtype=torch.float32,
             device="cpu", trainable: bool = False,
             remat: bool | None = None) -> ResidualTransformer:
    """A ResidualTransformer holding a reference-layout state dict; weights
    given as ``<name>.q`` / ``<name>.s`` load as W8A8 ``QuantWeight``s
    (``trainable``: with gradients, for ``train.py``; not for W8A8 weights;
    ``remat``: the model's per-layer rematerialization)."""
    model = ResidualTransformer(cfg, remat)
    for key in sd:
        if key.endswith(".q"):
            owner, name = key[:-2].rsplit(".", 1)
            sg = sd.get(key[:-2] + ".sg")
            set_weight(model.get_submodule(owner), name,
                       QuantWeight.empty(*sd[key].shape, groups=0 if sg is None else sg.shape[0]))
    if trainable and any(k.endswith(".q") for k in sd):
        raise ValueError("a W8A8 NAR does not train: load the f32 weights")
    return _load(model, {k: _np(v) for k, v in sd.items()}, dtype, device, trainable)


# --- the JAX package's parameter pytrees, in reference naming ----------------

def _flat3(w):
    """(3, D, ...) stacked in-projection -> torch's fused (3D, ...)."""
    w = _np(w)
    return w.reshape(3 * w.shape[1], *w.shape[2:])


def _weight(out: dict, key: str, leaf, i, fn=lambda a: a) -> None:
    """Entry ``i`` of a stacked weight, through ``fn`` (which takes and
    returns output rows first), under ``key``; a quantized leaf gives
    ``key.q`` and ``key.s`` ({"q", "s"}) or ``key.sg`` ({"q", "sg"}: (..., G,
    N) group scales, through ``fn`` along their output axis, to (G, N'))."""
    if not isinstance(leaf, dict):
        out[key] = fn(_np(leaf[i]))
        return
    out[key + ".q"] = fn(_np(leaf["q"][i]))
    if "sg" in leaf:
        out[key + ".sg"] = np.moveaxis(fn(np.moveaxis(_np(leaf["sg"][i]), -2, -1)), -1, 0)
    else:
        out[key + ".s"] = fn(_np(leaf["s"][i]))


def _stack_to_sd(stack, prefix: str, n_layers: int, out: dict) -> None:
    layers = stack["layers"]
    for i in range(n_layers):
        pre = f"{prefix}.layers.{i}"
        g = lambda k: _np(layers[k][i])
        _weight(out, f"{pre}.self_attn.in_proj_weight", layers["sa_in_w"], i, _flat3)
        out[f"{pre}.self_attn.in_proj_bias"] = _flat3(g("sa_in_b"))
        _weight(out, f"{pre}.self_attn.out_proj.weight", layers["sa_out_w"], i)
        out[f"{pre}.self_attn.out_proj.bias"] = g("sa_out_b")
        _weight(out, f"{pre}.activation.W.weight", layers["WV"], i,
                lambda a: a[: a.shape[0] // 2])
        _weight(out, f"{pre}.activation.V.weight", layers["WV"], i,
                lambda a: a[a.shape[0] // 2:])
        _weight(out, f"{pre}.linear2.weight", layers["lin2_w"], i)
        out[f"{pre}.linear2.bias"] = g("lin2_b")
        for n in ("norm1", "norm2"):
            out[f"{pre}.{n}.weight"] = g(f"{n}_w")
            out[f"{pre}.{n}.bias"] = g(f"{n}_b")
        if "ca_in_w" in layers:
            _weight(out, f"{pre}.multihead_attn.in_proj_weight", layers["ca_in_w"], i,
                    _flat3)
            out[f"{pre}.multihead_attn.in_proj_bias"] = _flat3(g("ca_in_b"))
            _weight(out, f"{pre}.multihead_attn.out_proj.weight", layers["ca_out_w"], i)
            out[f"{pre}.multihead_attn.out_proj.bias"] = g("ca_out_b")
            out[f"{pre}.norm3.weight"] = g("norm3_w")
            out[f"{pre}.norm3.bias"] = g("norm3_b")
    out[f"{prefix}.norm.weight"] = _np(stack["norm_w"])
    out[f"{prefix}.norm.bias"] = _np(stack["norm_b"])


def codeclm_reference_state_dict(params, cfg: CodecLMConfig) -> dict:
    """JAX AR pytree -> reference ``CodecLM`` state dict (wq/wk interleaved)."""
    layers = params["ar"]["layers"]
    sd = {"embed.weight": _np(params["embed"])}
    for i in range(cfg.n_layers):
        pre = f"ar.layers.{i}"
        sd[f"{pre}.attention.wq.weight"] = unpermute_rope_rows(_np(layers["wq"][i]),
                                                               cfg.head_dim)
        sd[f"{pre}.attention.wk.weight"] = unpermute_rope_rows(_np(layers["wk"][i]),
                                                               cfg.head_dim)
        for w in ("wv", "wo"):
            sd[f"{pre}.attention.{w}.weight"] = _np(layers[w][i])
        for w in ("w1", "w2", "w3"):
            sd[f"{pre}.feed_forward.{w}.weight"] = _np(layers[w][i])
        for n in ("attention_norm", "ffn_norm"):
            sd[f"{pre}.{n}.weight"] = _np(layers[n][i])
    sd["ar.norm.weight"] = _np(params["ar"]["norm"])
    sd["ar.output.weight"] = _np(params["ar"]["output"])
    sd["pos_embedding.alpha"] = _np(params["pos_alpha"])
    for i in range(cfg.n_codebooks):
        sd[f"ref_chunked_emb.embs.{i}.weight"] = _np(params["ref_chunked_emb"][i])
    sd["spk_identity_emb.weight"] = _np(params["spk_identity_emb"])
    _stack_to_sd(params["spk_encoder"], "spk_encoder", cfg.n_spk_layers, sd)
    return sd


def fused_pack_from_jax(fp) -> dict:
    """The JAX package's ``prepare_fused`` bundle (numpy arrays) -> the port's
    K2 pack (``ops/kernels/decode_layer.build_fused_pack`` layout), with the
    same integer values and scales.

    The JAX pack is (L * (4d + 3 hidden), d or d/2) rows of [wq | wk | wv |
    wo | w1 | w3 | w2 transposed] with per-chunk scales; its int4 w2 pairs
    nibbles along the output axis, the port's along the input axis."""
    from ..ops.kernels.decode_layer import pack4, unpack4

    an = _np(fp["attn_norms"])[:, 0]
    L, d = an.shape
    pack = np.array(_np(fp["pack"]))
    rpl, pw = pack.shape[0] // L, pack.shape[1]
    hidden = (rpl - 4 * d) // 3
    fch = hidden // 2
    w4 = pw == d // 2
    g = 2 if w4 else 1
    P = torch.from_numpy(pack.reshape(L, rpl, pw))
    S = torch.from_numpy(np.array(_np(fp["scales"])).reshape(L, 10, 2, -1))

    def scales(chunks, rows):
        return torch.cat([S[:, c, :g, :rows] for c in chunks], dim=-1).contiguous()

    out = {"wqkv": P[:, :3 * d], "sqkv": scales((0, 1, 2), d),
           "wo": P[:, 3 * d:4 * d], "so": scales((3,), d),
           "w13": P[:, 4 * d:4 * d + 2 * hidden], "s13": scales((4, 5, 6, 7), fch),
           "s2": torch.from_numpy(np.array(_np(fp["w2_scales"])[:, 0]))}
    w2t = P[:, 4 * d + 2 * hidden:]                               # (L, hidden, pw)
    if w4:
        lo, hi = unpack4(w2t)                                     # output halves
        w2 = torch.cat([lo, hi], dim=-1).transpose(1, 2)          # (L, d, hidden)
        out["w2"] = pack4(w2[..., :fch], w2[..., fch:])
    else:
        out["w2"] = w2t.transpose(1, 2)
    out["attn_norms"] = torch.from_numpy(an.astype(np.float32))
    out["ffn_norms"] = torch.from_numpy(_np(fp["ffn_norms"])[:, 0].astype(np.float32))
    for k in ("head_q", "head_s", "head4_p", "head4_s", "final_norm", "embed"):
        if k in fp:
            a = _np(fp[k])      # bf16 (a numpy extension type) widens to f32
            out[k] = torch.from_numpy(np.array(a, np.float32 if a.dtype.kind == "V" else a.dtype))
    return {k: v.contiguous() for k, v in out.items()}


def nar_reference_state_dict(params, cfg: ResidualTransformerConfig) -> dict:
    """JAX NAR pytree -> reference ``ResidualTransformer`` state dict (with
    ``.q`` / ``.s`` entries where the pytree went through ``quantize_nar``)."""
    sd = {"text_embed.weight": _np(params["text_embed"]),
          "cond_pos_embedding.alpha": _np(params["cond_pos_alpha"]),
          "pos_embedding.alpha": _np(params["pos_alpha"]),
          "ref_pos_embedding.alpha": _np(params["ref_pos_alpha"]),
          "spk_identity_emb.weight": _np(params["spk_identity_emb"])}
    for mlp, name in (("t_enc_mlp", "timestep_encoder_emb"),
                      ("t_dec_mlp", "timestep_decoder_emb")):
        for j, idx in ((0, 0), (1, 2)):
            sd[f"{name}.{idx}.weight"] = _np(params[mlp][f"w{j}"])
            sd[f"{name}.{idx}.bias"] = _np(params[mlp][f"b{j}"])
    _stack_to_sd(params["encoder"], "tfm.encoder", cfg.enc_layers, sd)
    _stack_to_sd(params["decoder"], "tfm.decoder", cfg.dec_layers, sd)
    _stack_to_sd(params["spk_encoder"], "spk_encoder", cfg.n_spk_layers, sd)
    for i in range(cfg.c_quant_levels):
        sd[f"ref_embedder.embs.{i}.weight"] = _np(params["ref_embedder"][i])
        sd[f"residual_encoder.embs.{i}.weight"] = _np(params["residual_encoder"][i])
    rd = params["residual_decoder"]
    for i in range(cfg.pred_quant_levels):
        sd[f"residual_decoder.{i}.0.weight"] = _np(rd["ln_w"][i])
        sd[f"residual_decoder.{i}.0.bias"] = _np(rd["ln_b"][i])
        _weight(sd, f"residual_decoder.{i}.1.weight", rd["lin_w"], i)
        sd[f"residual_decoder.{i}.1.bias"] = _np(rd["lin_b"][i])
    return sd
