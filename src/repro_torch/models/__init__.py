"""The LM stack: architecture configs, layers and model assembly."""
