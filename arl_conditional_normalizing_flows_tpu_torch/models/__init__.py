"""Flow models: config/static derivations, subnets, the conv flow."""
