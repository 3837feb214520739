"""Models of the port: the Llama family, forward-only serving path."""
