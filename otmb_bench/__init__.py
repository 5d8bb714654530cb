"""The benchmark of otmb_tpu_torch: one cell, one run (`python -m otmb_bench.run`)."""
