#!/bin/sh
# Decode a .dsv to Y4M with the torch port and package it as mp4 via
# ffmpeg (interop convenience, mirrors the reference's dsv2mp4.sh and
# tools/dsv2mp4.sh). usage: dsv2mp4.sh video.dsv out.mp4
# The decode runs on DSV2_TORCH_DEVICE (default cuda); PYTHON names the
# interpreter (default python).
set -e
SRC="$1"
OUT="${2:-out.mp4}"
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}" \
    "${PYTHON:-python}" -m dsv2_tpu_torch d -y -inp="$SRC" -out=- -y4m=1 | \
    ffmpeg -loglevel quiet -nostats -hide_banner -y -i - -c:v libx264 \
        -qp 0 -preset fast "$OUT"
