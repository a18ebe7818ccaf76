"""One general loop per kind of traffic; a mix names its loop."""
