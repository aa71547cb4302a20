"""``mars5_tts_torch/tools/profile_ar.py`` and ``profile_nar.py`` run end to
end on the CPU at a tiny width (their ``--device cpu`` dry runs) and print
the keys PERF.md reads."""

import json
import runpy
import sys

import pytest
import torch

ROOT = __file__.rsplit("/tests/", 1)[0]


@pytest.mark.parametrize("engine", ["fused4-head4", "bf16"])
def test_profile_ar_dry_run(engine, monkeypatch, capsys):
    from mars5_tts_torch.models import ar

    tiny = ar.CodecLMConfig(n_vocab=1400, dim=256, n_heads=4, n_kv_heads=4, head_dim=64,
                            n_layers=1, hidden_dim=512, sliding_window=3000, n_spk_layers=1,
                            spk_hidden_dim=256)
    monkeypatch.setattr(ar.CodecLMConfig, "mars5", staticmethod(lambda n_vocab: tiny))
    monkeypatch.setattr(sys, "argv", ["profile_ar.py", "--device", "cpu", "--engine", engine,
                                      "--tokens", "2", "--repeat", "1", "--root", ROOT])
    torch.manual_seed(0)
    with pytest.raises(SystemExit) as done:
        runpy.run_path(f"{ROOT}/mars5_tts_torch/tools/profile_ar.py", run_name="__main__")
    assert done.value.code == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["engine"] == engine and out["tokens"] == 2
    for key in ("wall_ms_per_token", "wall_ms_per_token_after_profiler",
                "device_ms_per_token", "stream_syncs_per_token", "top_host_ops_us_per_token"):
        assert key in out
    assert ("k2_device_ms" in out) == (engine != "bf16")
    assert ("k2_launches_per_call" in out) == (engine != "bf16")


def test_profile_ar_dry_run_four_rows(monkeypatch, capsys):
    """``--rows 4`` runs the batched quantized engine and one K2 call of four rows."""
    from mars5_tts_torch.models import ar

    tiny = ar.CodecLMConfig(n_vocab=1400, dim=256, n_heads=4, n_kv_heads=4, head_dim=64,
                            n_layers=1, hidden_dim=512, sliding_window=3000, n_spk_layers=1,
                            spk_hidden_dim=256)
    monkeypatch.setattr(ar.CodecLMConfig, "mars5", staticmethod(lambda n_vocab: tiny))
    monkeypatch.setattr(sys, "argv", ["profile_ar.py", "--device", "cpu", "--rows", "4",
                                      "--tokens", "2", "--repeat", "1", "--root", ROOT])
    torch.manual_seed(0)
    with pytest.raises(SystemExit) as done:
        runpy.run_path(f"{ROOT}/mars5_tts_torch/tools/profile_ar.py", run_name="__main__")
    assert done.value.code == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["rows"] == 4 and out["tokens"] == 2 and "k2_device_ms" in out


class _Event:
    """A stub of one ``key_averages()`` entry."""

    def __init__(self, key, device_type, self_device_us, count=1, annotation=False):
        from torch.autograd import DeviceType

        self.key, self.count, self.is_user_annotation = key, count, annotation
        self.device_type = getattr(DeviceType, device_type)
        self.self_device_time_total = self_device_us


def test_profile_ar_counts_device_events_once():
    """A host op's device time repeats its kernels' and a user annotation's
    spans them: the busy time counts the device's own events once, and K2's
    time only K2's kernels (the persistent step, or the launch sequence it
    replaced), with their launches."""
    tool = runpy.run_path(f"{ROOT}/mars5_tts_torch/tools/profile_ar.py")
    events = [
        _Event("aten::mm", "CPU", 30.0),                  # its kernel's time, again
        _Event("ampere_sgemm_128x64", "CUDA", 30.0),
        _Event("k2_range", "CUDA", 500.0, annotation=True),
        _Event("void (anonymous namespace)::fused_decode_step((anonymous namespace)::Args)",
               "CUDA", 400.0, count=2),
        _Event("void (anonymous namespace)::gemv_kernel<0, true, true>(GemvArgs)", "CUDA",
               50.0, count=3),
        _Event("void (anonymous namespace)::head4_kernel(signed char const*)", "CUDA", 7.0),
        _Event("Memcpy HtoD (Pageable -> Device)", "CUDA", 2.0),
        _Event("cudaLaunchKernel", "CPU", 0.0, count=5),
        _Event("cudaLaunchCooperativeKernel", "CPU", 0.0, count=2),
        _Event("cudaLaunchKernelExC", "CPU", 0.0, count=1),
    ]
    assert tool["device_us"](events) == 30.0 + 400.0 + 50.0 + 7.0 + 2.0
    assert tool["k2_kernels"](events) == (450.0, 5)
    assert tool["launches"](events) == 8


@pytest.mark.parametrize("nar", ["int8", "bf16", "int8 --mega"])
def test_profile_nar_dry_run(nar, monkeypatch, capsys):
    from mars5_tts_torch.models import nar as nar_mod

    from mars5_tts_torch.models import layers

    for name in ("fused_linear", "fused_ffn", "mega_decoder_stack"):   # the tool wraps them
        monkeypatch.setattr(layers, name, getattr(layers, name))    # restored after
    cfg = nar_mod.ResidualTransformerConfig.tiny()
    if "--mega" in nar:                             # K9 takes head dim 64, D a multiple of 128
        cfg = nar_mod.ResidualTransformerConfig(n_text_vocab=32, dim=128, nhead=2, enc_layers=1,
                                                dec_layers=2, n_spk_layers=1, t_emb_dim=64,
                                                hidden_dim=256)
    monkeypatch.setattr(nar_mod.ResidualTransformerConfig, "mars5",
                        staticmethod(lambda n_text_vocab: cfg))
    monkeypatch.setattr(sys, "argv", ["profile_nar.py", "--device", "cpu", "--nar", *nar.split(),
                                      "--prompt", "8", "--gen", "4", "--steps", "2",
                                      "--repeat", "1", "--profile-steps", "1", "--root", ROOT])
    torch.manual_seed(0)
    with pytest.raises(SystemExit) as done:
        runpy.run_path(f"{ROOT}/mars5_tts_torch/tools/profile_nar.py", run_name="__main__")
    assert done.value.code == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["nar"] == nar.split()[0] and out["frames"] == 12 and out["steps"] == 2
    assert out["profile_steps"] == 1
    for key in ("wall_ms_per_step", "wall_ms_per_step_runs", "device_ms_per_step",
                "device_idle_share", "k1_device_ms_per_step", "k3_device_ms_per_step",
                "k4_device_ms_per_step", "w8a8_kernels_device_ms_per_step",
                "w8a8_kernel_us_per_launch", "launches_per_step",
                "stream_syncs_per_step", "top_host_ops_us_per_step"):
        assert key in out
    mega_keys = ("k9_device_ms_per_step", "k9_calls_per_step", "outside_k9_device_ms_per_step",
                 "outside_k9_device_ms_per_step_by_kernel")
    assert all((key in out) == ("--mega" in nar) for key in mega_keys)
    if "--mega" in nar:          # the K9 range ran once a profiled step, on the host here
        assert out["top_host_ops_us_per_step"].get("mega_k9", 0) > 0


def test_profile_nar_splits_device_time_at_the_k9_spans():
    """Kernels that start inside a K9 call's device span are K9's; the rest
    are summed by name, and a kernel's name loses its return type,
    namespaces and arguments."""
    tool = runpy.run_path(f"{ROOT}/mars5_tts_torch/tools/profile_nar.py")
    kernels = [("a", 0.0, 5.0), ("w8a8_prologue", 10.0, 12.0), ("a", 20.0, 25.0),
               ("b", 30.0, 31.0), ("mega_attn_kernel", 33.0, 39.0)]
    assert tool["outside_spans"](kernels, [(9.0, 13.0), (32.0, 40.0)]) == {"a": 10.0, "b": 1.0}
    assert tool["short_name"](
        "void (anonymous namespace)::w8a8_wgmma_gemm<256, false>(CUtensorMap, CUtensorMap, "
        "(anonymous namespace)::Epilogue)") == "w8a8_wgmma_gemm<256, false>"
    assert tool["short_name"]("void at::native::elementwise_kernel<128, 4, at::native::"
                              "F<float> >(int, at::native::F<float>)") == (
        "elementwise_kernel<128, 4, at::native::F<float> >")
    assert tool["short_name"]("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"


def test_kernel_ab_checks(monkeypatch):
    """kernel_ab.py's per-turn script compiles, and a check it does not know
    is refused before any turn runs."""
    tool = runpy.run_path(f"{ROOT}/mars5_tts_torch/tools/kernel_ab.py")
    compile(tool["CHECKS"], "kernel_ab checks", "exec")
    monkeypatch.setattr(sys, "argv", ["kernel_ab.py", ROOT, ROOT, "--checks", "k2,k7"])
    with pytest.raises(SystemExit) as done:
        tool["main"]()
    assert done.value.code == 2


def test_kernel_ab_takes_the_w8a8_checks(monkeypatch, capsys):
    """``k3`` and ``k3g`` (K3/K4 at one group and grouped) are checks
    kernel_ab.py knows; their lines pass its filter."""
    tool = runpy.run_path(f"{ROOT}/mars5_tts_torch/tools/kernel_ab.py")
    assert 'S.check_nar_fused_grouped(dev)' in tool["CHECKS"]
    for line in ("K3 grouped qkv (2, 1200, 1024) -> 3072, G = 8, LN + bias: ...",
                 "K3/K4 grouped plan on 132 SMs ...", "K4 grouped ffn per launch, device us",
                 "K3 qkv (2, 1200, 1024) -> 3072, LN + bias: ..."):
        assert line.startswith(tool["PREFIXES"])
    monkeypatch.setattr(sys, "argv", ["kernel_ab.py", ROOT, ROOT, "--checks", "k3,k3x"])
    with pytest.raises(SystemExit) as done:
        tool["main"]()
    assert done.value.code == 2 and "k3x" in capsys.readouterr().err


def test_kernel_ab_takes_the_k1_int8_check():
    """``k1q`` (K1's int8 mode at the smoke's four shapes, with each call's
    kernels by device time) is a check kernel_ab.py knows, for a checkout
    whose smoke splits K1's launches or not; its lines pass the filter."""
    tool = runpy.run_path(f"{ROOT}/mars5_tts_torch/tools/kernel_ab.py")
    assert "S.check_k1_modes(dev)" in tool["CHECKS"] and 'S.W8A8_KERNELS = ("mha_",)' in tool["CHECKS"]
    for line in ("K1 int8 (2, 1200) masked (2, 1200, 16, 64) over 1200 keys mask=True: ...",
                 "K1 int8 (2, 725) strided per launch, device us: mha_int8_prepass_k 3.1"):
        assert line.startswith(tool["PREFIXES"])


MHA_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115mha_int8_kernelE14CUtensorMap_stS0_S0_PKfS2_PKhP13__nv_bfloat16iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115mha_int8_kernelE14CUtensorMap_stS0_S0_PKfS2_PKhP13__nv_bfloat16iiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 1 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118mha_int8_prepass_vEPK13__nv_bfloat16iiiNS_7StridesEPKfiPfPa' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118mha_int8_prepass_vEPK13__nv_bfloat16iiiNS_7StridesEPKfiPfPa
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 8704 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119mha_fwd_bf16_kernelE14CUtensorMap_stS0_S0_PKhP13__nv_bfloat16iiif' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119mha_fwd_bf16_kernelE14CUtensorMap_stS0_S0_PKhP13__nv_bfloat16iiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


def test_chip_smoke_reads_the_mha_ptxas_log():
    """The same reading for K1's kernels, which take no template arguments:
    only those named by the prefix, each with its registers and spills."""
    smoke = runpy.run_path(f"{ROOT}/chip_smoke.py")
    regs, wgmma = smoke["ptxas_lines"](MHA_PTXAS_LOG, ("mha_int8_",))
    assert regs == {
        "mha_int8_kernel": "128 registers, 0 bytes spill stores, 0 bytes spill loads",
        "mha_int8_prepass_v": "30 registers, 4 bytes spill stores, 4 bytes spill loads"}
    assert wgmma == []


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115w8a8_wgmma_gemmILi64ELb1ELi1EEEv14CUtensorMap_stS1_NS_8EpilogueE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115w8a8_wgmma_gemmILi64ELb1ELi1EEEv14CUtensorMap_stS1_NS_8EpilogueE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117w8a8_wgmma_swigluILi128ELi2EEEv14CUtensorMap_stS1_S1_NS_8EpilogueE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117w8a8_wgmma_swigluILi128ELi2EEEv14CUtensorMap_stS1_S1_NS_8EpilogueE
    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115w8a8_wgmma_gemmILi128ELb0ELi2EEEv14CUtensorMap_stS1_NS_8EpilogueE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115w8a8_wgmma_gemmILi128ELb0ELi2EEEv14CUtensorMap_stS1_NS_8EpilogueE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 560 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113w8a8_prologueILb1ELi8ELb0EEEvPK13__nv_bfloat16PKvS5_ifPaPfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_113w8a8_prologueILb1ELi8ELb0EEEvPK13__nv_bfloat16PKvS5_ifPaPfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 4096 bytes smem, 400 bytes cmem[0]
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized
"""


def test_chip_smoke_reads_the_ptxas_log():
    """chip_smoke.py's reading of nvcc's -Xptxas -v log: each GEMM's template
    arguments, registers and spills, and the lines about wgmma."""
    smoke = runpy.run_path(f"{ROOT}/chip_smoke.py")
    regs, wgmma = smoke["ptxas_lines"](PTXAS_LOG, ("w8a8_wgmma_gemm", "w8a8_wgmma_swiglu"))
    assert regs == {
        "w8a8_wgmma_gemm<64, 1, 1>": "168 registers, 0 bytes spill stores, 0 bytes spill loads",
        "w8a8_wgmma_gemm<128, 0, 2>": "168 registers, 0 bytes spill stores, 0 bytes spill loads",
        "w8a8_wgmma_swiglu<128, 2>": "168 registers, 16 bytes spill stores, 12 bytes spill loads"}
    assert wgmma == ["ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
                     "instructions are serialized"]


@pytest.mark.parametrize("name,label", [
    ("void (anonymous namespace)::w8a8_wgmma_gemm<256, true>(CUtensorMap, CUtensorMap, "
     "Epilogue)", "w8a8_wgmma_gemm<256, true>"),
    ("void (anonymous namespace)::w8a8_wgmma_swiglu<128>(CUtensorMap, CUtensorMap)",
     "w8a8_wgmma_swiglu<128>"),
    ("void (anonymous namespace)::w8a8_prologue<true, 8>(__nv_bfloat16 const*, void const*)",
     "w8a8_prologue<true, 8>"),
    ("void (anonymous namespace)::w8a8_prologue<false, 24>(__nv_bfloat16 const*)",
     "w8a8_prologue<false, 24>"),
    ("void (anonymous namespace)::w8a8_gemm_kernel<true, 1>((anonymous namespace)::Args)",
     "w8a8_gemm_kernel<true, 1>"),
    ("void (anonymous namespace)::mha_fwd_bf16_kernel(CUtensorMap)", None),
])
def test_profile_nar_labels_the_w8a8_kernels(name, label):
    """Each W8A8 kernel's device us a launch is keyed by its name without
    namespace and arguments; other kernels are not W8A8 kernels."""
    tool = runpy.run_path(f"{ROOT}/mars5_tts_torch/tools/profile_nar.py")
    assert tool["w8a8_label"](name) == label


@pytest.mark.parametrize("site", ["fused_linear", "fused_ffn"])
def test_profile_nar_marks_the_w8a8_sites(site, monkeypatch):
    """The decoder layer's K3 and K4 calls run inside a profiler range named
    for their site, once a call, and return what the wrapper returns."""
    from torch.profiler import ProfilerActivity, profile

    from mars5_tts_torch.models import layers
    from mars5_tts_torch.ops.kernels import nar_fused as F
    from mars5_tts_torch.ops.quant import quantize_weight

    for name in ("fused_linear", "fused_ffn"):
        monkeypatch.setattr(layers, name, getattr(layers, name))    # restored after the test
    tool = runpy.run_path(f"{ROOT}/mars5_tts_torch/tools/profile_nar.py")
    tool["mark_w8a8_sites"](layers)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 128), generator=g).bfloat16()
    ln = (torch.ones(128), torch.zeros(128))
    w = [quantize_weight(torch.randn(shape, generator=g) * 0.05)
         for shape in ((256, 128), (256, 128), (128, 256))]
    args = (x, w[0]) if site == "fused_linear" else (x, ln, *w, torch.zeros(128))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = getattr(layers, site)(*args)
    want = getattr(F, site)(*args)
    assert torch.equal(got, want)
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get(tool["SITES"][site]) == 1


@pytest.mark.parametrize("with_log", [True, False])
def test_build_reads_back_the_log_of_a_library_built_before(with_log, tmp_path, monkeypatch):
    """A library found built (no nvcc run) brings back the nvcc log kept
    beside it, which chip_smoke.py's spill gate reads; without that file
    there is no log, and the gate fails."""
    from mars5_tts_torch.ops.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "build_log", {})
    monkeypatch.setattr(build, "nvcc", lambda: pytest.fail("a built library is not rebuilt"))
    sources = build.LIBRARIES["nar_fused"]
    lib = build.library_path("nar_fused", sources)
    lib.write_bytes(b"")
    if with_log:
        lib.with_suffix(".log").write_text(PTXAS_LOG)
    assert build.build("nar_fused", sources) == lib
    assert build.build_log.get("nar_fused") == (PTXAS_LOG if with_log else None)
