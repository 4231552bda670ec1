#!/usr/bin/env python3
"""Experiment entry script of the PyTorch/CUDA port (dgod_tpu_torch) on one
NVIDIA card — the same flags as train_driving_dg.py. Example:

  python3 train_driving_dg_torch.py --model FRCNN --exp dg \
      --source_domains ABC --target_domains I --weights_folder ABC2I \
      --weights_file abc2i_dgfrcnn --reg_weights 0.5 0.5 0.5 0.05 0.0001
"""

if __name__ == "__main__":
    # imported here, not at the top: a spawned loader child re-runs this
    # file's top level, and the CLI's imports (torch, the models) would
    # only slow its start
    from dgod_tpu_torch.cli import main

    main()
