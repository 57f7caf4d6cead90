"""Matrix-completion experiment configs (``nomad_mf``)."""
