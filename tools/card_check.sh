#!/usr/bin/env bash
# The port's whole check on one CUDA card, run from the root of a checkout:
#
#   bash tools/card_check.sh LOG_DIR
#
# 1. python3 chip_smoke.py (builds every kernel, drives every path, holds
#    each kernel against its plain version), its output in LOG_DIR/smoke.log;
# 2. the card's tests, tests/test_torch_gpu.py, in LOG_DIR/gpu_tests.log;
# 3. chip_smoke.py copied alone into an empty directory, where it must fail,
#    in LOG_DIR/lone.log.
# Prints the card's name and power limit, the versions, each step's exit
# code and seconds and the end of its log. Exits 0 only when steps 1 and 2
# pass and step 3 fails.
set -u
log=$(realpath -m "${1:?usage: bash tools/card_check.sh LOG_DIR}")
mkdir -p "$log"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'

t0=$SECONDS
python3 chip_smoke.py > "$log/smoke.log" 2>&1
smoke=$?
echo "smoke_rc=$smoke smoke_s=$((SECONDS - t0))"
tail -n 2 "$log/smoke.log" | cut -c1-400

t0=$SECONDS
python3 -m pytest tests/test_torch_gpu.py -q -p no:cacheprovider \
    > "$log/gpu_tests.log" 2>&1
gpu=$?
echo "gpu_tests_rc=$gpu gpu_tests_s=$((SECONDS - t0))"
tail -n 1 "$log/gpu_tests.log"

lone=$(mktemp -d)
cp chip_smoke.py "$lone/"
(cd "$lone" && python3 chip_smoke.py) > "$log/lone.log" 2>&1
alone=$?
rm -rf "$lone"
echo "lone_rc=$alone"
tail -n 1 "$log/lone.log"

[ "$smoke" -eq 0 ] && [ "$gpu" -eq 0 ] && [ "$alone" -ne 0 ]
