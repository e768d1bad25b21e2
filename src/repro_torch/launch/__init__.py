"""Launch entry points: the step functions, the serving and training loops."""
