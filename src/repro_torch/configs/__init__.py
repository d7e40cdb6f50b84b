"""The paper's linear-classification presets (port of ``repro.configs.fdsvrg_linear``)."""
