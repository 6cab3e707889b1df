"""Factor batches, GP priors and sigma-point moments."""
