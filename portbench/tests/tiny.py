"""The tiny geometry the CPU tests run the cells at: every model cut to a few
layers of at most 128 columns (the widths the quantized kernels' plain twins
take), the traffic cut to a few frames, the limits of the cell kept."""

from __future__ import annotations

TINY = {
    "ar": {"n_vocab": 1300, "dim": 128, "n_heads": 2, "n_kv_heads": 2, "head_dim": 64,
           "n_layers": 2, "hidden_dim": 256, "sliding_window": 3000, "norm_eps": 1e-05,
           "n_spk_layers": 1, "spk_hidden_dim": 192, "codebook_size": 1025, "n_codebooks": 8},
    "nar": {"n_text_vocab": 300, "n_quant": 1025, "dim": 128, "nhead": 2, "enc_layers": 1,
            "dec_layers": 2, "n_spk_layers": 1, "c_quant_levels": 8, "pred_quant_levels": 8,
            "t_emb_dim": 128, "hidden_dim": 256},
    "encodec": {"channels": 1, "dimension": 16, "n_filters": 4, "ratios": [4, 2],
                "kernel_size": 7, "last_kernel_size": 7, "residual_kernel_size": 3,
                "compress": 2, "lstm_layers": 2, "n_q": 8, "codebook_size": 1024,
                "sample_rate": 24000},
    "vocos": {"input_channels": 16, "dim": 16, "intermediate_dim": 32, "num_layers": 1,
              "adanorm_num_embeddings": 4, "n_fft": 32, "hop_length": 8, "n_codebooks": 8,
              "codebook_size": 1024, "eps": 1e-06},
}
# the tiny Encodec's hop is 8 samples (3,000 frames a second): outputs of
# 60-240 frames, so that a row serves enough tokens for a share of them
TRAFFIC = {"ref_seconds": [0.01, 0.02], "chars_per_second": 500.0, "timesteps": 8}
OUT = {"lognormal": {"dist": "lognormal", "median": 0.04, "sigma": 0.5, "clip": [0.02, 0.08]},
       "uniform": {"dist": "uniform", "range": [0.03, 0.06]}}


def shrink(spec):
    """``run.run_cell``'s override: the tiny widths and traffic."""
    spec["config"].update({k: dict(v) for k, v in TINY.items()})
    t = spec["traffic"]
    t.update(TRAFFIC)
    t["out_seconds"] = dict(OUT[t["out_seconds"]["dist"]])
    t["strata"] = 2
    t["rows"] = min(t.get("rows", 1), 2)       # a batch of two rows: the CPU twins are slow
