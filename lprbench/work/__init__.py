"""Work arithmetic, one file a kernel or model count."""
