"""The LM substrate of the port: dense-family layers (`layers`) and the
model assembly with its serving entry points (`lm`)."""
