"""Grid geometry, topology and wet-cell indices."""
