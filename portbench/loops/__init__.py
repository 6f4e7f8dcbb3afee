"""The traffic mixes' loops, each found by the name a traffic file gives."""
