"""Core services of the port: device resolution, flags, shape buckets."""
