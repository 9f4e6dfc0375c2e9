"""Step functions. Serving steps so far; the training steps come with the
training slice."""
