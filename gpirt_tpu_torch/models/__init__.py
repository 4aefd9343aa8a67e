"""Configuration, the Gibbs sweep and the chain loop."""
