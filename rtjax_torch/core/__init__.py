"""Core math: component-triple vectors, sampling, geometry, random words."""
