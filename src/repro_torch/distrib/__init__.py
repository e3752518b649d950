"""Plan tables and their one-device executor."""
