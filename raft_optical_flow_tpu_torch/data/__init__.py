"""Training data: synthetic warped pairs and the batch loader."""
