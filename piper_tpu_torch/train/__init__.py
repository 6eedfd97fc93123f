"""Training: losses, the training forward, the GAN step and its
optimizers, the dataset reader and the trainer (python -m
piper_tpu_torch.train). Counterpart of piper_tpu/train/, without
preprocessing from raw audio (train/preprocess.py, train/norm_audio.py):
the trainer reads the dataset directory that preprocessing writes."""
