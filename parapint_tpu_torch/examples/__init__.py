"""Example problems with the model written in torch."""
