"""The three-call protocol facades."""
