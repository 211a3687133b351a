"""Routes to the server, one file a route, found by the mix's ``route``."""
