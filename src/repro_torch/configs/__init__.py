"""Model, optimizer and train configs (copies of ``repro.configs``)."""
