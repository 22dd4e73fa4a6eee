"""Tools of the port: the report tools, the forensics smoke and the chip-run
comparison scripts (the latter run as files)."""
