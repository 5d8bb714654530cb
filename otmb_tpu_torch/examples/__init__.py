"""The JAX package's four examples on the port's API, at their sizes and
seeds: `end_to_end` (the CLI's `demo`), `water_masses`, `density_pipeline`
and `calibrate_kappa`. Each `main(device=None)` prints the JAX example's
lines in its format and returns those numbers as a dict; left out,
`device` is the current CUDA device. Run one with

    python -m otmb_tpu_torch.examples.<name> [--device cpu]
"""

import argparse


def parser(doc: str) -> argparse.ArgumentParser:
    """The examples' command line: `--device` (default: the current CUDA
    device)."""
    p = argparse.ArgumentParser(description=doc,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None,
                   help='torch device, e.g. "cuda:0" or "cpu" (default: the current CUDA '
                        'device)')
    return p
