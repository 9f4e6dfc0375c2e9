"""Step functions: training, evaluation and serving."""
