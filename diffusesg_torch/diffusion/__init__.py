"""EDM noise schedules and preconditioning."""
