"""Host-side signal preprocessing and synthetic strip rendering."""
