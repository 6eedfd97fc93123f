"""Training: preprocessing from raw audio (python -m
piper_tpu_torch.train.preprocess, with the bundled Silero VAD), losses,
the training forward, the GAN step and its optimizers, the dataset
reader and the trainer (python -m piper_tpu_torch.train). Counterpart of
piper_tpu/train/: the trainer reads the dataset directory that
preprocessing writes."""
