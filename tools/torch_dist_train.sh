#!/usr/bin/env bash
# Data-parallel training with the PyTorch port: one process per GPU of
# this host, the global batch split over them (tools/dist_train.sh's
# surface; parallel/mesh.py).
#
#   tools/torch_dist_train.sh CONFIG GPUS [torch_train.py options ...]
#
# e.g. tools/torch_dist_train.sh cl_faster_rcnn_cfgs/incremental_task/cl_faster_rcnn_nsgp_repre_15_5_1.py 8 \
#          --work-dir work_dirs/15_5_1
CONFIG=$1
GPUS=$2
shift 2
exec torchrun --standalone --nproc_per_node="$GPUS" "$(dirname "$0")/torch_train.py" "$CONFIG" "$@"
