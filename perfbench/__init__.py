"""The benchmark of penguin_tpu_torch: a harness driven by data files."""
