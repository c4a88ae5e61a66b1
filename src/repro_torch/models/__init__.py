"""The LM model zoo's layers, attention, blocks and model assembly."""
