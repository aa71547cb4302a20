"""The port's checkpoint and parameter I/O (``mars5_tts_torch/hub.py``) and
its official-checkpoint converters against the JAX package's.

* ``.npz`` parameter trees: each package reads what the other wrote (nested
  dicts and lists), equal trees.
* ``save_checkpoint`` -> both packages' ``load_checkpoint``: equal tensors,
  vocab and ``mars5_config``; the JAX writer's file through the port's
  loader; ``.pt`` files in the reference layout and as a bare state dict;
  the port's ``.pt`` writer (a config under ``"config"``, which the JAX
  loader ignores); unsupported suffixes refused.
* ``load_codec_params`` on seeded official-key Encodec and Vocos state dicts
  (``tests/torch_replicas``; Encodec with weight norm and folded, each as
  written and in a ``state_dict`` wrapper): the port's pytree equals the
  JAX package's leaf for leaf (values and dtypes).
* Through ``encodec_from_pytree`` / ``vocos_from_pytree`` at tiny geometry:
  Encodec codes identical to JAX ``encodec_encode``'s; Vocos audio within
  atol 1e-4 of JAX ``vocos_vocode``'s (f32 sums and FFTs differ between the
  frameworks by a few ulp).
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from mars5_tts_torch import hub as P  # noqa: E402
from mars5_tts_tpu import hub as J  # noqa: E402
from tests.torch_port_fixtures import make_tokenizers  # noqa: E402
from tests.torch_replicas import make_encodec_state_dict, make_vocos_state_dict  # noqa: E402

AUDIO_ATOL = 1e-4


def _tree():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "layers": [{"w": rng.standard_normal(5).astype(np.float32),
                        "i": np.arange(6, dtype=np.int64).reshape(2, 3)}
                       for _ in range(12)],
            "nested": {"x": {"y": np.float32(2.5) * np.ones(2, np.float32)},
                       "bits": np.array([1, 0, 1], np.int8)}}


def assert_tree_equal(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_equal(g, w, f"{path}/{i}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("writer,reader", [(P, J), (J, P), (P, P)])
def test_npz_trees_cross_load(tmp_path, writer, reader):
    tree = _tree()
    path = tmp_path / "tree.npz"
    writer.save_pytree_npz(path, tree)
    assert_tree_equal(reader.load_pytree_npz(path), tree)


def test_npz_writers_agree_on_keys_and_torch_leaves(tmp_path):
    tree = _tree()
    P.save_pytree_npz(tmp_path / "p.npz", tree)
    J.save_pytree_npz(tmp_path / "j.npz", tree)
    p, j = np.load(tmp_path / "p.npz"), np.load(tmp_path / "j.npz")
    assert sorted(p.files) == sorted(j.files)
    assert "layers/11/w" in p.files
    as_torch = {"a": torch.from_numpy(tree["a"]), "layers": [{"w": torch.ones(2)}]}
    P.save_pytree_npz(tmp_path / "t.npz", as_torch)
    assert_tree_equal(J.load_pytree_npz(tmp_path / "t.npz"),
                      {"a": tree["a"], "layers": [{"w": np.ones(2, np.float32)}]})


def _ckpt():
    rng = np.random.default_rng(1)
    _, _, text_str, speech_str = make_tokenizers()
    model = {"embed.weight": rng.standard_normal((7, 4)).astype(np.float32),
             "ar.norm.weight": rng.standard_normal(4).astype(np.float32),
             "counts": np.arange(5, dtype=np.int64)}
    vocab = {"texttok.model": text_str, "speechtok.model": speech_str}
    return model, vocab, {"dim": 4, "n_layers": 1}


def _assert_ckpt(got, model, vocab, config):
    assert got["vocab"] == vocab
    assert set(got["model"]) == set(model)
    for k, v in model.items():
        assert got["model"][k].dtype == v.dtype
        np.testing.assert_array_equal(got["model"][k], v)
    if config is not None:
        assert got["config"] == config


@pytest.mark.parametrize("writer", [P, J])
def test_safetensors_checkpoint_loads_in_both(tmp_path, writer):
    model, vocab, config = _ckpt()
    path = tmp_path / "m.safetensors"
    writer.save_checkpoint(path, model, vocab, config=config)
    for reader in (P, J):
        _assert_ckpt(reader.load_checkpoint(path), model, vocab, config)
    assert P.load_tokenizers(P.load_checkpoint(path))[0].vocab.keys() == \
        J.load_tokenizers(J.load_checkpoint(path))[0].vocab.keys()


def test_pt_checkpoints_load_alike(tmp_path):
    model, vocab, _ = _ckpt()
    tmodel = {k: torch.from_numpy(v) for k, v in model.items()}
    torch.save({"vocab": vocab, "model": tmodel}, tmp_path / "ref.pt")
    torch.save(tmodel, tmp_path / "bare.pth")
    P.save_checkpoint(tmp_path / "port.pt", model, vocab)
    for name, want_vocab in (("ref.pt", vocab), ("bare.pth", {}), ("port.pt", vocab)):
        for reader in (P, J):
            _assert_ckpt(reader.load_checkpoint(tmp_path / name), model, want_vocab, None)
    raw = torch.load(tmp_path / "port.pt", weights_only=False)
    assert set(raw) == {"vocab", "model"} and isinstance(raw["model"]["counts"], torch.Tensor)
    # a config rides along under "config"; the JAX loader reads the rest alike
    P.save_checkpoint(tmp_path / "cfg.pt", model, vocab, config={"dim": 4})
    _assert_ckpt(P.load_checkpoint(tmp_path / "cfg.pt"), model, vocab, {"dim": 4})
    _assert_ckpt(J.load_checkpoint(tmp_path / "cfg.pt"), model, vocab, None)


def test_unsupported_checkpoint_formats_raise(tmp_path):
    model, vocab, config = _ckpt()
    (tmp_path / "m.ckpt").write_bytes(b"")
    for reader in (P, J):
        with pytest.raises(ValueError, match="unsupported checkpoint format"):
            reader.load_checkpoint(tmp_path / "m.ckpt")
    with pytest.raises(ValueError, match="unsupported checkpoint format"):
        P.save_checkpoint(tmp_path / "m.ckpt", model, vocab)
    with pytest.raises(ValueError, match="unknown codec kind"):
        torch.save({}, tmp_path / "c.pt")
        P.load_codec_params(tmp_path / "c.pt", "hifigan")


def _cfgs():
    from mars5_tts_torch.models.encodec import EncodecConfig as PE
    from mars5_tts_torch.models.vocos import VocosConfig as PV
    from mars5_tts_tpu.models.encodec import EncodecConfig as JE
    from mars5_tts_tpu.models.vocos import VocosConfig as JV

    je = JE(dimension=16, n_filters=4, ratios=(4, 2), n_q=8, codebook_size=1024)
    jv = JV(input_channels=16, dim=16, intermediate_dim=32, num_layers=2, n_fft=64,
            hop_length=16, n_codebooks=8, codebook_size=1024)
    return (je, PE(**dataclasses.asdict(je))), (jv, PV(**dataclasses.asdict(jv)))


def _folded(sd):
    """The Encodec state dict with every weight-normed conv folded into a
    plain ``weight`` (the other form ``_fold_weight_norm`` reads)."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight_v"):
            pre = k[: -len(".weight_v")]
            g = sd[pre + ".weight_g"]
            out[pre + ".weight"] = g * v / v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
        elif not k.endswith(".weight_g"):
            out[k] = v
    return out


@pytest.mark.parametrize("form", ["weight_norm", "folded", "state_dict_wrapper", "npz"])
def test_encodec_params_and_codes_equal_jax(tmp_path, form):
    from mars5_tts_torch.models.encodec import encodec_from_pytree
    from mars5_tts_tpu.models.encodec import encodec_encode

    (jcfg, pcfg), _ = _cfgs()
    _, _, sd = make_encodec_state_dict(jcfg, seed=3)
    assert any(k.endswith("weight_g") for k in sd)
    path = tmp_path / "encodec.pt"
    if form == "folded":
        sd = _folded(sd)
        assert not any(k.endswith("weight_g") for k in sd)
    torch.save({"state_dict": sd} if form == "state_dict_wrapper" else sd, path)
    want = J.load_codec_params(str(path), "encodec", jcfg)
    if form == "npz":
        J.save_pytree_npz(tmp_path / "encodec.npz", want)
        path = tmp_path / "encodec.npz"
    got = P.load_codec_params(path, "encodec", pcfg)
    assert_tree_equal(got, want)

    enc = encodec_from_pytree(got).eval()
    assert enc.cfg == pcfg
    for n in (1600, 2001):
        audio = (np.random.default_rng(n).standard_normal((1, 1, n)) * 0.3).astype(np.float32)
        ref = np.asarray(encodec_encode(want, jcfg, jnp.asarray(audio)))
        np.testing.assert_array_equal(enc(torch.from_numpy(audio)).numpy(), ref)


@pytest.mark.parametrize("form", ["as_written", "state_dict_wrapper"])
def test_vocos_params_and_audio_close_to_jax(tmp_path, form):
    from mars5_tts_torch.models.vocos import vocos_from_pytree
    from mars5_tts_tpu.models.vocos import vocos_vocode

    _, (jcfg, pcfg) = _cfgs()
    _, _, sd = make_vocos_state_dict(jcfg, seed=4)
    path = tmp_path / "vocos.pt"
    torch.save({"state_dict": sd} if form == "state_dict_wrapper" else sd, path)
    want = J.load_codec_params(str(path), "vocos", jcfg)
    got = P.load_codec_params(path, "vocos", pcfg)
    assert_tree_equal(got, want)

    voc = vocos_from_pytree(got, pcfg)
    tokens = np.random.default_rng(5).integers(0, 1024, (29, 8))
    ref = np.asarray(vocos_vocode(want, jcfg, jnp.asarray(tokens)))
    out = voc.vocode(torch.from_numpy(tokens)).numpy()
    assert out.shape == ref.shape == (29 * 16,)
    np.testing.assert_allclose(out, ref, rtol=0, atol=AUDIO_ATOL)


def test_codec_converters_take_half_precision_tensors():
    """An f16 official state dict converts to the values its f32 upcast gives
    (the JAX converters' ``np.asarray(v, np.float32)``)."""
    from mars5_tts_torch.models.encodec import convert_encodec
    from mars5_tts_tpu.models.encodec import convert_encodec as j_convert

    (jcfg, pcfg), _ = _cfgs()
    _, _, sd = make_encodec_state_dict(jcfg, seed=6)
    half = {k: v.detach().half() for k, v in sd.items()}
    assert_tree_equal(convert_encodec(half, pcfg),
                      j_convert({k: v.numpy() for k, v in half.items()}, jcfg))
