"""numpy oracles (float64) for the torch package."""
