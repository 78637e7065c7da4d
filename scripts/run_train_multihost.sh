#!/bin/bash
# Multi-host distillation training: one invocation of this script per
# host. The cluster spec rides in TF_CONFIG — the exact shape the
# reference's dispatcher consumed (train.py:704-733) — and is parsed by
# parallel/distributed.py into jax.distributed.initialize().
#
#   # fresh model (explicitly):
#   START_NEW_MODEL=True NUM_HOSTS=2 HOST_INDEX=0 COORDINATOR=10.0.0.1:7077 ./run_train_multihost.sh
#   START_NEW_MODEL=True NUM_HOSTS=2 HOST_INDEX=1 COORDINATOR=10.0.0.1:7077 ./run_train_multihost.sh
#   # relaunch-and-resume (the fault-tolerance flow) is the DEFAULT:
#   NUM_HOSTS=2 HOST_INDEX=0 COORDINATOR=10.0.0.1:7077 ./run_train_multihost.sh
#
# Semantics (all handled inside the binaries — see cli/train.py):
#   * --batch_size is the GLOBAL batch; each host loads its
#     1/NUM_HOSTS slice from its own disjoint set of input shards
#     (there must be >= NUM_HOSTS input files);
#   * the global batch is assembled with
#     jax.make_array_from_process_local_data; gradients all-reduce
#     across hosts (NCCL);
#   * host 0 (the "master" job) owns summaries and checkpoints; with
#     CHECKPOINT_FORMAT=orbax every host writes its own shards;
#   * TRAIN_DIR must be shared storage (NFS/GCS-fuse) so eval jobs and
#     resume see one checkpoint stream;
#   * one process per host, driving all of that host's cards. A JAX
#     process reserves most of a card's memory when it starts, so two
#     processes on one machine must each get their own cards: give each
#     its own CUDA_VISIBLE_DEVICES (or jax.distributed.initialize's
#     local_device_ids).
#   * checkpoints default to msgpack (replicated data-parallel state,
#     written by host 0); CHECKPOINT_FORMAT=orbax writes per-host shards
#     and needs the orbax-checkpoint package.
set -e
NUM_HOSTS=${NUM_HOSTS:-2}
HOST_INDEX=${HOST_INDEX:-0}
COORDINATOR=${COORDINATOR:-127.0.0.1:7077}
if [[ "$COORDINATOR" != *:* ]]; then
  echo "COORDINATOR must be host:port (got '$COORDINATOR')" >&2
  exit 1
fi
TRAIN_DIR=${TRAIN_DIR:-./model_HLSTM_TeaStud_every10_train/}
DATA=${DATA:-"./yt8m/train*.tfrecord"}
mkdir -p "$TRAIN_DIR"

# reference cluster-spec shape: one master + workers, master first
WORKERS=""
for ((i = 1; i < NUM_HOSTS; i++)); do
  WORKERS+="\"${COORDINATOR%:*}:$((${COORDINATOR##*:} + i))\""
  [ "$i" -lt $((NUM_HOSTS - 1)) ] && WORKERS+=", "
done
if [ "$HOST_INDEX" -eq 0 ]; then
  TASK='{"type": "master", "index": 0}'
else
  TASK="{\"type\": \"worker\", \"index\": $((HOST_INDEX - 1))}"
fi
export TF_CONFIG="{\"cluster\": {\"master\": [\"$COORDINATOR\"], \"worker\": [$WORKERS]}, \"task\": $TASK}"

time python -u -m efficientvideoclassification_youtube8m_tpu.cli.train \
  --train_data_pattern "$DATA" --train_dir "$TRAIN_DIR" \
  --frame_features True --feature_names "rgb, audio" --feature_sizes "1024, 128" \
  --model "HierarchicalLstmModel" --batch_size ${BATCH_SIZE:-512} \
  --num_inputs_to_lstm 20 --lstm_layers 2 \
  --start_new_model ${START_NEW_MODEL:-False} --num_epochs ${EPOCH:-1} \
  --every_n 10 --base_learning_rate 0.001 \
  --checkpoint_format ${CHECKPOINT_FORMAT:-msgpack}
