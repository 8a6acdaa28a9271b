"""Request kinds, one per file, found by the name a traffic mix gives under "request"."""
