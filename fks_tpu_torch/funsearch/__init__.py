"""Policy search: device-resident parametric evolution, and code
candidates — the sandbox, the template, the transpiler and the VM."""
