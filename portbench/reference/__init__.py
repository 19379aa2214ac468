"""The plain reference: plain PyTorch, no import of the measured program."""
