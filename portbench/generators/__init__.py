"""Input generators, one per configuration kind, found by the name a configuration gives."""
