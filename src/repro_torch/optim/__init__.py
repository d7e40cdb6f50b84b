"""The update-rule layer (port of ``repro.optim.update_rules``)."""
