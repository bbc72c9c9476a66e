"""Training (the port of ``repro.training``): ``optimizer`` (AdamW with
float32 moments and a global-norm clip), ``compression`` (int8 gradient
quantization) and ``train_loop`` (``TrainConfig``, ``make_train_step``,
``Trainer``)."""
