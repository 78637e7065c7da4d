#!/bin/bash
# Training of Dynamic Teacher and Student on Train Data.
# Mirror of the reference's run_train.sh canonical flags
# (/root/reference/run_train.sh), per-epoch backup protocol included.
set -e
TRAIN_DIR=${TRAIN_DIR:-./model_HLSTM_TeaStud_every10_train/}
DATA=${DATA:-"./yt8m/train*.tfrecord"}
EPOCH=${EPOCH:-1}
mkdir -p "$TRAIN_DIR"

time python -u -m efficientvideoclassification_youtube8m_tpu.cli.train \
  --train_data_pattern "$DATA" --train_dir "$TRAIN_DIR" \
  --frame_features True --feature_names "rgb, audio" --feature_sizes "1024, 128" \
  --model "HierarchicalLstmModel" --batch_size 256 --num_inputs_to_lstm 20 \
  --lstm_layers 2 --start_new_model ${START_NEW_MODEL:-True} --num_epochs 1 \
  --every_n 10 &> output_HLSTM_TeaStud_every10_after_${EPOCH}epc

# per-epoch checkpoint backup (run_train.sh:8-12)
mkdir -p "$TRAIN_DIR/backup_epc${EPOCH}"
cp -r "$TRAIN_DIR"/model.ckpt* "$TRAIN_DIR/backup_epc${EPOCH}/" 2>/dev/null || true
mv "$TRAIN_DIR"/events* "$TRAIN_DIR/backup_epc${EPOCH}/" 2>/dev/null || true
cp "$TRAIN_DIR"/check* "$TRAIN_DIR/backup_epc${EPOCH}/" 2>/dev/null || true
