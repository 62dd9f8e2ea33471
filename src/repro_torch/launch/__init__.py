"""Launch helpers of the port: the device mesh (`launch.mesh`)."""
