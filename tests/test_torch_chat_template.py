"""The port's chat-template renderer against ``apply_chat_template``.

The templates of the registry's families, written here as their
checkpoints publish them (TinyLlama-Chat, Llama-3 and Llama-3.1 headers,
Mistral's ``[INST]`` that raises on roles that do not alternate, Qwen2.5's
``im_start``, Qwen3's, Gemma-2's turns that raise on a system role), are
rendered by ``engine/chat_template.py`` and by ``transformers`` (jinja2)
on hypothesis conversations: the same text, or both raise.  Then the
engines: ``TorchEngine._format_chat`` equals ``JaxEngine._format_chat`` on
the same directory, with its template, without one (the flattening), and
when the template raises (a warning, then the flattening); a template
using a construct outside the subset warns, naming it, and flattens.
"""

import logging

import pytest

pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
pytest.importorskip("jinja2")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from crowdllama_tpu_torch.engine import chat_template as ct  # noqa: E402

TINYLLAMA = (
    "{% for message in messages %}\n{% if message['role'] == 'user' %}\n"
    "{{ '<|user|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'system' %}\n"
    "{{ '<|system|>\n' + message['content'] + eos_token }}\n"
    "{% elif message['role'] == 'assistant' %}\n"
    "{{ '<|assistant|>\n'  + message['content'] + eos_token }}\n"
    "{% endif %}\n{% if loop.last and add_generation_prompt %}\n"
    "{{ '<|assistant|>' }}\n{% endif %}\n{% endfor %}")

LLAMA3 = (
    "{% set loop_messages = messages %}{% for message in loop_messages %}"
    "{% set content = '<|start_header_id|>' + message['role'] + "
    "'<|end_header_id|>\n\n'+ message['content'] | trim + '<|eot_id|>' %}"
    "{% if loop.index0 == 0 %}{% set content = bos_token + content %}"
    "{% endif %}{{ content }}{% endfor %}{% if add_generation_prompt %}"
    "{{ '<|start_header_id|>assistant<|end_header_id|>\n\n' }}{% endif %}")

LLAMA31 = """{{- bos_token }}
{%- if custom_tools is defined %}
    {%- set tools = custom_tools %}
{%- endif %}
{%- if not tools_in_user_message is defined %}
    {%- set tools_in_user_message = true %}
{%- endif %}
{%- if not date_string is defined %}
    {%- set date_string = "26 Jul 2024" %}
{%- endif %}
{%- if not tools is defined %}
    {%- set tools = none %}
{%- endif %}

{#- This block extracts the system message, so we can slot it into the right place. #}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}

{#- System message + builtin tools #}
{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{%- if builtin_tools is defined or tools is not none %}
    {{- "Environment: ipython\\n" }}
{%- endif %}
{%- if builtin_tools is defined %}
    {{- "Tools: " + builtin_tools | reject('equalto', 'code_interpreter') | join(", ") + "\\n\\n"}}
{%- endif %}
{{- "Cutting Knowledge Date: December 2023\\n" }}
{{- "Today Date: " + date_string + "\\n\\n" }}
{%- if tools is not none and not tools_in_user_message %}
    {{- "You have access to the following functions. To call a function, please respond with JSON for a function call." }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\\n\\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
{%- endif %}
{{- system_message }}
{{- "<|eot_id|>" }}

{#- Custom tools are passed in a user message with some extra guidance #}
{%- if tools_in_user_message and not tools is none %}
    {#- Extract the first user message so we can plug it in here #}
    {%- if messages | length != 0 %}
        {%- set first_user_message = messages[0]['content']|trim %}
        {%- set messages = messages[1:] %}
    {%- else %}
        {{- raise_exception("Cannot put tools in the first user message when there's no first user message!") }}
{%- endif %}
    {{- '<|start_header_id|>user<|end_header_id|>\\n\\n' -}}
    {{- "Given the following functions, please respond with a JSON for a function call " }}
    {{- "with its proper arguments that best answers the given prompt.\\n\\n" }}
    {{- 'Respond in the format {"name": function name, "parameters": dictionary of argument name and its value}.' }}
    {{- "Do not use variables.\\n\\n" }}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
    {{- first_user_message + "<|eot_id|>"}}
{%- endif %}

{%- for message in messages %}
    {%- if not (message.role == 'ipython' or message.role == 'tool' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {%- if builtin_tools is defined and tool_call.name in builtin_tools %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' -}}
            {{- "<|python_tag|>" + tool_call.name + ".call(" }}
            {%- for arg_name, arg_val in tool_call.arguments | items %}
                {{- arg_name + '="' + arg_val + '"' }}
                {%- if not loop.last %}
                    {{- ", " }}
                {%- endif %}
                {%- endfor %}
            {{- ")" }}
        {%- else  %}
            {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' -}}
            {{- '{"name": "' + tool_call.name + '", ' }}
            {{- '"parameters": ' }}
            {{- tool_call.arguments | tojson }}
            {{- "}" }}
        {%- endif %}
        {%- if builtin_tools is defined %}
            {#- This means we're in ipython mode #}
            {{- "<|eom_id|>" }}
        {%- else %}
            {{- "<|eot_id|>" }}
        {%- endif %}
    {%- elif message.role == "tool" or message.role == "ipython" %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\\n\\n" }}
        {%- if message.content is mapping or message.content is iterable %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}
{%- endif %}
"""

MISTRAL = (
    "{{ bos_token }}{% for message in messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate "
    "user/assistant/user/assistant/...') }}{% endif %}"
    "{% if message['role'] == 'user' %}"
    "{{ '[INST] ' + message['content'] + ' [/INST]' }}"
    "{% elif message['role'] == 'assistant' %}"
    "{{ message['content'] + eos_token}}"
    "{% else %}{{ raise_exception('Only user and assistant roles are "
    "supported!') }}{% endif %}{% endfor %}")

QWEN25 = """{%- if tools %}
    {{- '<|im_start|>system\\n' }}
    {%- if messages[0]['role'] == 'system' %}
        {{- messages[0]['content'] }}
    {%- else %}
        {{- 'You are Qwen, created by Alibaba Cloud. You are a helpful assistant.' }}
    {%- endif %}
    {{- "\\n\\n# Tools\\n\\nYou may call one or more functions to assist with the user query.\\n\\nYou are provided with function signatures within <tools></tools> XML tags:\\n<tools>" }}
    {%- for tool in tools %}
        {{- "\\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\\n</tools>\\n\\nFor each function call, return a json object with function name and arguments within <tool_call></tool_call> XML tags:\\n<tool_call>\\n{\\"name\\": <function-name>, \\"arguments\\": <args-json-object>}\\n</tool_call><|im_end|>\\n" }}
{%- else %}
    {%- if messages[0]['role'] == 'system' %}
        {{- '<|im_start|>system\\n' + messages[0]['content'] + '<|im_end|>\\n' }}
    {%- else %}
        {{- '<|im_start|>system\\nYou are Qwen, created by Alibaba Cloud. You are a helpful assistant.<|im_end|>\\n' }}
    {%- endif %}
{%- endif %}
{%- for message in messages %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) or (message.role == "assistant" and not message.tool_calls) %}
        {{- '<|im_start|>' + message.role + '\\n' + message.content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {{- '<|im_start|>' + message.role }}
        {%- if message.content %}
            {{- '\\n' + message.content }}
        {%- endif %}
        {%- for tool_call in message.tool_calls %}
            {%- if tool_call.function is defined %}
                {%- set tool_call = tool_call.function %}
            {%- endif %}
            {{- '\\n<tool_call>\\n{"name": "' }}
            {{- tool_call.name }}
            {{- '", "arguments": ' }}
            {{- tool_call.arguments | tojson }}
            {{- '}\\n</tool_call>' }}
        {%- endfor %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if (loop.index0 == 0) or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- message.content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
{%- endif %}
"""

QWEN3 = """{%- if tools %}
    {{- '<|im_start|>system\\n' }}
    {%- if messages[0].role == 'system' %}
        {{- messages[0].content + '\\n\\n' }}
    {%- endif %}
    {{- "# Tools\\n\\nYou may call one or more functions to assist with the user query.\\n\\nYou are provided with function signatures within <tools></tools> XML tags:\\n<tools>" }}
    {%- for tool in tools %}
        {{- "\\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\\n</tools>\\n\\nFor each function call, return a json object with function name and arguments within <tool_call></tool_call> XML tags:\\n<tool_call>\\n{\\"name\\": <function-name>, \\"arguments\\": <args-json-object>}\\n</tool_call><|im_end|>\\n" }}
{%- else %}
    {%- if messages[0].role == 'system' %}
        {{- '<|im_start|>system\\n' + messages[0].content + '<|im_end|>\\n' }}
    {%- endif %}
{%- endif %}
{%- set ns = namespace(multi_step_tool=true, last_query_index=messages|length - 1) %}
{%- for message in messages[::-1] %}
    {%- set index = (messages|length - 1) - loop.index0 %}
    {%- if ns.multi_step_tool and message.role == "user" and message.content is string and not(message.content.startswith('<tool_response>') and message.content.endswith('</tool_response>')) %}
        {%- set ns.multi_step_tool = false %}
        {%- set ns.last_query_index = index %}
    {%- endif %}
{%- endfor %}
{%- for message in messages %}
    {%- if message.content is string %}
        {%- set content = message.content %}
    {%- else %}
        {%- set content = '' %}
    {%- endif %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) %}
        {{- '<|im_start|>' + message.role + '\\n' + content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {%- set reasoning_content = '' %}
        {%- if message.reasoning_content is string %}
            {%- set reasoning_content = message.reasoning_content %}
        {%- else %}
            {%- if '</think>' in content %}
                {%- set reasoning_content = content.split('</think>')[0].rstrip('\\n').split('<think>')[-1].lstrip('\\n') %}
                {%- set content = content.split('</think>')[-1].lstrip('\\n') %}
            {%- endif %}
        {%- endif %}
        {%- if loop.index0 > ns.last_query_index %}
            {%- if loop.last or (not loop.last and reasoning_content) %}
                {{- '<|im_start|>' + message.role + '\\n<think>\\n' + reasoning_content.strip('\\n') + '\\n</think>\\n\\n' + content.lstrip('\\n') }}
            {%- else %}
                {{- '<|im_start|>' + message.role + '\\n' + content }}
            {%- endif %}
        {%- else %}
            {{- '<|im_start|>' + message.role + '\\n' + content }}
        {%- endif %}
        {%- if message.tool_calls %}
            {%- for tool_call in message.tool_calls %}
                {%- if (loop.first and content) or (not loop.first) %}
                    {{- '\\n' }}
                {%- endif %}
                {%- if tool_call.function %}
                    {%- set tool_call = tool_call.function %}
                {%- endif %}
                {{- '<tool_call>\\n{"name": "' }}
                {{- tool_call.name }}
                {{- '", "arguments": ' }}
                {%- if tool_call.arguments is string %}
                    {{- tool_call.arguments }}
                {%- else %}
                    {{- tool_call.arguments | tojson }}
                {%- endif %}
                {{- '}\\n</tool_call>' }}
            {%- endfor %}
        {%- endif %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if loop.first or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
    {%- if enable_thinking is defined and enable_thinking is false %}
        {{- '<think>\\n\\n</think>\\n\\n' }}
    {%- endif %}
{%- endif %}"""

GEMMA2 = (
    "{{ bos_token }}{% if messages[0]['role'] == 'system' %}"
    "{{ raise_exception('System role not supported') }}{% endif %}"
    "{% for message in messages %}"
    "{% if (message['role'] == 'user') != (loop.index0 % 2 == 0) %}"
    "{{ raise_exception('Conversation roles must alternate "
    "user/assistant/user/assistant/...') }}{% endif %}"
    "{% if (message['role'] == 'assistant') %}{% set role = 'model' %}"
    "{% else %}{% set role = message['role'] %}{% endif %}"
    "{{ '<start_of_turn>' + role + '\n' + message['content'] | trim + "
    "'<end_of_turn>\n' }}{% endfor %}{% if add_generation_prompt %}"
    "{{'<start_of_turn>model\n'}}{% endif %}")

TEMPLATES = {"tinyllama": TINYLLAMA, "llama3": LLAMA3, "llama3.1": LLAMA31,
             "mistral": MISTRAL, "qwen2.5": QWEN25, "qwen3": QWEN3,
             "gemma2": GEMMA2}
SPECIALS = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>"}


def _hf_tokenizer(template: str):
    from tokenizers import Tokenizer, models
    from transformers import PreTrainedTokenizerFast

    tok = Tokenizer(models.WordLevel({"<unk>": 0, "<s>": 1, "</s>": 2},
                                     unk_token="<unk>"))
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, **SPECIALS)
    fast.chat_template = template
    return fast


def _render_both(template: str, messages: list[dict]):
    """(port's text or its exception type name, the oracle's likewise)."""
    def port():
        return ct.Template(template).render(
            messages=[dict(m) for m in messages], tools=None, documents=None,
            add_generation_prompt=True, **SPECIALS)

    def oracle():
        return _hf_tokenizer(template).apply_chat_template(
            [dict(m) for m in messages], tokenize=False,
            add_generation_prompt=True)

    out = []
    for fn in (port, oracle):
        try:
            out.append(fn())
        except Exception as e:  # noqa: BLE001 - both must raise alike
            out.append(("raised", "TemplateError" in type(e).__name__))
    return out


_CONTENT = st.one_of(
    st.text(max_size=30),
    st.sampled_from(["", " padded ", "{{ not a tag }}", "{% raw %}",
                     "line\nbreak\n", "<think>why</think>\n\nbecause",
                     "'quotes' \"double\"", "tab\there", "emoji 🙂",
                     "<tool_response>x</tool_response>", "\\n escaped"]))
_ROLE = st.sampled_from(["system", "user", "assistant"])
_ANY = st.lists(st.fixed_dictionaries({"role": _ROLE, "content": _CONTENT}),
                min_size=1, max_size=5)


@st.composite
def _alternating(draw):
    n = draw(st.integers(1, 5))
    msgs = [{"role": "system", "content": draw(_CONTENT)}] if draw(
        st.booleans()) else []
    for i in range(n):
        msgs.append({"role": "user" if i % 2 == 0 else "assistant",
                     "content": draw(_CONTENT)})
    return msgs


@pytest.mark.parametrize("family", list(TEMPLATES))
@settings(max_examples=50, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(messages=st.one_of(_alternating(), _ANY))
def test_render_equals_apply_chat_template(family, messages):
    port, oracle = _render_both(TEMPLATES[family], messages)
    assert port == oracle


@pytest.mark.parametrize("family,messages", [
    ("mistral", [{"role": "user", "content": "a"},
                 {"role": "user", "content": "b"}]),
    ("gemma2", [{"role": "system", "content": "s"},
                {"role": "user", "content": "u"}]),
])
def test_raising_templates_raise_template_error(family, messages):
    with pytest.raises(ct.TemplateError):
        ct.Template(TEMPLATES[family]).render(
            messages=messages, add_generation_prompt=True, **SPECIALS)
    assert _render_both(TEMPLATES[family], messages) == [("raised", True)] * 2


# ----------------------------------------------------------------- engines

def _engines(path):
    from crowdllama_tpu.config import Configuration
    from crowdllama_tpu.engine.engine import JaxEngine
    from crowdllama_tpu.engine.tokenizer import get_tokenizer as j_get
    from crowdllama_tpu_torch.engine.engine import TorchEngine
    from crowdllama_tpu_torch.engine.tokenizer import get_tokenizer

    jeng = JaxEngine(Configuration(model="tiny-test", model_path=str(path)))
    jeng.tokenizer = j_get(str(path))
    teng = TorchEngine(device="cpu", model="tiny-test",
                       model_path=str(path))
    teng.tokenizer = get_tokenizer(str(path))
    return jeng, teng


CHATS = [[{"role": "user", "content": "Hi there"}],
         [{"role": "system", "content": "Be brief."},
          {"role": "user", "content": "Hi"},
          {"role": "assistant", "content": "Hello."},
          {"role": "user", "content": "Again"}]]


@pytest.mark.parametrize("family,template,fallback", [
    ("tinyllama", None, False),          # the directory's own template
    ("mistral", None, True),             # no template: flattened
    ("gemma", GEMMA2, True),             # raises on the system role
    ("qwen", QWEN25, False),
    ("llama3", LLAMA31, False),
])
def test_engine_format_chat_matches_jax(tmp_path, caplog, family, template,
                                        fallback):
    from test_torch_hf_tokenizer import save_family

    from crowdllama_tpu_torch.core.messages import flatten_chat

    path = save_family(family, tmp_path / family)
    if template is not None:
        (path / "chat_template.jinja").write_text(template)
    jeng, teng = _engines(path)
    for chat in CHATS:
        with caplog.at_level(logging.WARNING):
            want = jeng._format_chat(chat)
            got = teng._format_chat(chat)
        assert got == want
        ids = teng.tokenizer.encode(got)
        assert ids == jeng.tokenizer.encode(want)
        if family == "llama3":
            # Both packages encode the rendered prompt with the special
            # tokens, so a template that writes its own BOS gets two.
            assert ids[:2] == [teng.tokenizer.bos_id] * 2
        assert (got == flatten_chat(chat)) == (
            fallback and (family != "gemma" or chat[0]["role"] == "system"))
    if family == "gemma":
        assert "chat template failed" in caplog.text


def test_unsupported_construct_warns_and_flattens(tmp_path, caplog):
    from test_torch_hf_tokenizer import save_family

    from crowdllama_tpu_torch.core.messages import flatten_chat
    from crowdllama_tpu_torch.engine.tokenizer import get_tokenizer

    path = save_family("qwen", tmp_path / "q")
    (path / "chat_template.jinja").write_text(
        "{% filter upper %}{{ messages[0]['content'] }}{% endfilter %}")
    with caplog.at_level(logging.WARNING):
        tok = get_tokenizer(str(path))
    assert "tag 'filter'" in caplog.text
    _, teng = _engines(path)
    teng.tokenizer = tok
    assert teng._format_chat(CHATS[0]) == flatten_chat(CHATS[0])
    with pytest.raises(ct.UnsupportedConstruct, match="filter 'wordwrap'"):
        ct.Template("{{ 'a'|wordwrap(3) }}")
    with pytest.raises(ct.UnsupportedConstruct, match="global 'cycler'"):
        ct.Template("{{ cycler(1, 2) }}")


def test_template_sources_follow_transformers(tmp_path):
    """``chat_template.jinja`` first, else ``tokenizer_config.json``'s
    ``chat_template``, the one named ``default`` of a list."""
    assert ct.template_source(tmp_path, {}) is None
    assert ct.template_source(tmp_path, {"chat_template": "A"}) == "A"
    assert ct.template_source(tmp_path, {"chat_template": [
        {"name": "tool_use", "template": "T"},
        {"name": "default", "template": "D"}]}) == "D"
    (tmp_path / "chat_template.jinja").write_text("J")
    assert ct.template_source(tmp_path, {"chat_template": "A"}) == "J"
