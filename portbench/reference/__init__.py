"""Plain PyTorch references of what the cells time, written from the
published descriptions (facebookresearch/dino `vision_transformer.py`,
`main_dino.py`, `utils.py`; SAIS `prepare_model.py` and torch's
`TransformerEncoderLayer`).  They import nothing of the program and take
only what the benchmark made: weights, inputs and step indices.

Every product goes through `mm`, `linear` or `conv` with an optional
operand rounding (`fp8_e4m3`), which is how a control computes the same
mathematics in a lower precision.  Float32 runs with TF32 off
(`float32_exact`)."""
