"""Model and shape configurations (the port's copy of ``repro.configs``)."""
