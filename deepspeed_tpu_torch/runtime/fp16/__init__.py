"""Mixed-precision support: fp16 loss scaling."""
