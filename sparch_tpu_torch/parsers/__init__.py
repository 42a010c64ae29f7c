"""Command-line flags of ``run_exp_torch.py`` (counterpart of
sparch_tpu/parsers)."""
