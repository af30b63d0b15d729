"""The query encoder's training path: the MiniLM distillation, the encoder
confidence calibration and the HuggingFace weight converter."""
