#!/bin/bash
# Drive all 8 CSV conversions with the port's converter (stdlib csv, no
# pandas): the port's counterpart of scripts/csv_conversion.sh, with the
# same flags (--data_root, --out, --category, --weather).
set -e
mkdir -p Annots
for ds in bdd10k cityscapes acdc idd; do
  for split in train val; do
    python3 -m dgod_tpu_torch.data.etl.convert --dataset $ds --image_set $split "$@"
  done
done
