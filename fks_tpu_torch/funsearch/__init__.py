"""Policy search: device-resident parametric evolution."""
