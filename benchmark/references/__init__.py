"""Plain references, one module a configuration's ``round``; they import
nothing of the port."""
