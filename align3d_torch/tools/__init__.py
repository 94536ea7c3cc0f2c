"""Tools of the port: the real RGB-D series and the roofline probes."""
