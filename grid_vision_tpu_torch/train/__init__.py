"""Training and evaluation of the torch port."""
