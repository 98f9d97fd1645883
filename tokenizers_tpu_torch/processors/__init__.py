"""Post-processors of the port (`template.TemplateProcessing`)."""
