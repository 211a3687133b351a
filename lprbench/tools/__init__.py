"""Tools that run a cell with more read out than its result line holds."""
