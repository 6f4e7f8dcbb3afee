"""A stand-in `gradio` module for the web UI's parity tests: the layout
containers are context managers, every widget constructor records its
arguments, and `Button.click` records (fn, inputs, outputs, api_name) in
the module's `clicks` list. Install it with
`monkeypatch.setitem(sys.modules, "gradio", make_gradio())`.
"""
import types


class _Component:
    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def describe(self):
        """What a widget is made of: its class and its arguments."""
        return (type(self).__name__, repr(self.args),
                repr(sorted(self.kwargs.items())))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def make_gradio():
    mod = types.ModuleType("gradio")
    mod.clicks = []

    class Button(_Component):
        def click(self, fn, inputs=None, outputs=None, api_name=None):
            mod.clicks.append(types.SimpleNamespace(
                fn=fn, inputs=list(inputs or []),
                outputs=list(outputs or []), api_name=api_name,
                button=self))

    mod.Button = Button
    for name in ("Blocks", "Tabs", "TabItem", "Row", "Column", "Accordion",
                 "Markdown", "Number", "Image", "Textbox", "Model3D",
                 "Dropdown", "Checkbox", "Slider", "Video"):
        setattr(mod, name, type(name, (_Component,), {}))
    return mod
