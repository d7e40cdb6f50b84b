"""The update-rule layer (port of ``repro.optim.update_rules``): SVRG with
one or k outputs, FD-SAGA and FD-BCD."""
