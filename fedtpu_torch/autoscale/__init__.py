"""The port's autoscale pieces: ``signals.slo_burn_from_hist`` only (the
control plane is ROADMAP A8c)."""
