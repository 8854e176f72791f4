"""Launch-side helpers of the port (cost model)."""
