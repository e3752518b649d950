"""The LM's communication-free data pipeline."""
