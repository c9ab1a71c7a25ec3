"""Region-QA conversation builders, counterpart of
`rga3_tpu/data/visual_prompts/builders.py`: the multiple-choice prompt
block, answer phrasing, per-instance shape and colour assignment, phrase
insertion, the VCR, Flickr30k, Visual7W and PointQA builders, and the
refcocog / vg_rel / osprey conversation templating (`vip_conv_generator`).

Every function makes the JAX package's `random` calls in the same order with
the same template strings, so that under the same seed the conversations
are the same strings.
"""
from __future__ import annotations

import collections
import random
import re
from typing import Dict, List, Optional, Sequence, Tuple

from ..templates import WORDS_SHAPE

ANSWER_MAP = {0: "A", 1: "B", 2: "C", 3: "D"}

# 
WHY_QUESTIONS = [
    'why?',
    'why',
    "What's the rationale for your decision?",
    'What led you to that conclusion?',
    "What's the reasoning behind your opinion?",
    'Why do you believe that to be true?',
    'Can you explain the basis for your thinking?',
    'What factors influenced your perspective?',
    'How did you arrive at that perspective?',
    'What evidence supports your viewpoint?',
    'What makes you think that way?',
    "What's the logic behind your argument?",
    'Can you provide some context for your opinion?',
    "What's the basis for your assertion?",
    'Why do you hold that belief?',
    'What experiences have shaped your perspective?',
    'What assumptions underlie your reasoning?',
    "What's the foundation of your assertion?",
    "What's the source of your reasoning?",
    "What's the motivation behind your decision?",
    "What's the impetus for your belief?",
    "What's the driving force behind your conclusion?",
    'Why do you think that?',
    "What's your reasoning?",
    'What makes you say that?',
    'Why do you feel that way?',
    "What's the story behind that?",
    "What's your thought process?",
    "What's the deal with that?",
    "What's the logic behind it?",
    'Why do you believe that?',
    "What's the real deal here?",
    "What's the reason behind it?",
    "What's the thought process behind your decision?",
    "What's the rationale for your opinion?",
    'Why do you have that impression?',
    "What's the background to that?",
    "What's the evidence that supports your view?",
    "What's the explanation for that?"
]

# 
QUESTION_PREFIXES = [
    'Based on the provided source image, please answer this question: ',
    'In the context of the source image, can you answer: ',
    'With reference to the source image, please respond to the following query: ',
    "Considering the source image, what's your answer to: ",
    'Please provide an answer for the subsequent question, keeping the source image in mind: ',
    'Taking into account the source image, please answer: ',
    'After observing the source image, could you please answer the following: ',
    'Upon examining the source image, what would your answer be to: ',
    'Using the source image as a reference, please respond to: ',
    'In light of the source image, could you please answer: '
]

OPTIONS_PREFIXES = [
    'Available choices are as follows: ',
    'Select from the options below: ',
    'You may choose from the following: ',
    'Your choices include: ',
    'Here are your options: ',
    'Please pick one from the given possibilities: ',
    'The following options are available: ',
    'You have the following selections: ',
    'Which among these would you choose: ',
    'You can select from these alternatives: '
]

# (`questions`): Flickr30k grounded-description modes
DESCRIBE_QUESTIONS = {
    "semantic": [
        "Please describe the image with the object referred to by the visual prompts; please do not mention the actual visual prompt.",
        "Describe the provided image using the semantic object referred to by the visual prompts. Please produce a sentence in natural language, and do not mention the actual visual prompts."
    ],
    "visual_prompt": [
        "Please describe the image with the object referred to by the visual prompts; please just mention the actual visual prompt and do not mention the semantic category.",
        "Please describe the image with the object referred to by the visual prompts; please just mention the actual visual prompt, such as a red box, and do not mention the semantic category, such as a dog."
    ],
    "semantic_visual_prompt": [
        "Please describe the image with the object referred to by the visual prompts; make sure to mention both the actual visual prompt and the semantic category.",
        "Please describe the image with the object referred to by the visual prompts; make sure to mention both the actual visual prompt, such as a red box, and the semantic category, such as a dog."
    ]
}


def build_prompt(question: str, options: Sequence[str]) -> str:
    """4-way multiple-choice prompt block."""
    if len(options) != 4:
        return "Error: Exactly 4 options are required."
    options_str = '\n'.join(
        f"{chr(65 + i)}. {option}" for i, option in enumerate(options)
    )
    return (
        f"{question}\n{options_str}\n"
        "Answer with the option's letter from the given choices directly."
    )


def add_period_and_autocorrect(annotation: str) -> str:
    """Capitalize, terminate, normalize comma spacing; abbreviation-safe."""
    abbreviations = ['Dr.', 'Mrs.', 'Mr.', 'Ms.', 'e.g.', 'i.e.', 'U.S.A.']
    for i, abbr in enumerate(abbreviations):
        annotation = annotation.replace(abbr, f"__ABBREVIATION{i}__")
    annotation = annotation.strip()
    annotation = annotation[0].upper() + annotation[1:]
    if annotation[-1] not in ['.', '!', '?']:
        annotation += '.'
    annotation = re.sub(r'\s*,\s*', ', ', annotation)
    for i, abbr in enumerate(abbreviations):
        annotation = annotation.replace(f"__ABBREVIATION{i}__", abbr)
    return annotation


def get_adjective() -> str:
    return random.choice([
        'The correct', 'The most accurate', 'The best', 'The ultimate',
        'The final', 'The only', 'The ideal', 'The optimal',
        'The most fitting', 'The definitive',
    ])


def get_punctuation() -> str:
    return random.choice([':', '->', '→', '::', '—', ';', '|',
                          '⇒'])


def get_answer(choice: int, content: str, use_multichoice_why: bool) -> str:
    """Randomized answer phrasing for multiple-choice turns.

    The candidate list is built eagerly — each f-string's
    get_adjective()/get_punctuation() call draws from `random` in textual
    order.
    """
    letter = ANSWER_MAP[choice].upper()
    if not use_multichoice_why:
        return content
    content = content[0].lower() + content[1:] if content else content
    content = random.choice([
        f'({letter})',
        f'({letter})',
        f'{get_adjective()} answer is ({letter})',
        f'{get_adjective()} answer is ({letter})',
        f'({letter}){get_punctuation()} {content}',
        f'({letter}){get_punctuation()} {content}',
        f'{get_adjective()} answer is ({letter}) — {content}',
        f'{get_adjective()} answer is ({letter}) — {content}',
        f'({letter}) — {get_adjective()} because {content}',
        f'({letter}) — {get_adjective()} because {content}',
        f'Answer ({letter}): {content}',
        f'Answer ({letter}): {content}',
        f'Opt for ({letter}) if {content}',
        f'Opt for ({letter}) if {content}',
    ])
    return content.replace("—", "-")


def get_all_instances(all_corpus: Sequence[Sequence]) -> List:
    """Unique instance indices referenced anywhere in the corpus, in
    `list(set(...))` order."""
    out = []
    for corpus in all_corpus:
        for instance in corpus:
            if isinstance(instance, list):
                out.extend(instance)
    return list(set(out))


def get_color_shape(
    all_instance_index: Sequence,
    shape_choices: Sequence[str],
    color_list: Sequence[Tuple[str, Tuple[int, int, int]]],
) -> Dict:
    """Assign each instance a (color_name, rgb, shape); instances sharing
    a shape get distinct named colors."""
    shapes = random.choices(shape_choices, k=len(all_instance_index))
    shape_counts = collections.Counter(shapes)
    non_unique_shapes = {s for s, c in shape_counts.items() if c > 1}
    results = {}
    shape_color_dict: Dict[str, List[str]] = {}
    for i, instance in enumerate(all_instance_index):
        shape = shapes[i]
        if shape not in shape_color_dict:
            shape_color_dict[shape] = []
        if shape_color_dict[shape] or shape in non_unique_shapes:
            available = [
                c for c in color_list if c[0] not in shape_color_dict[shape]
            ]
            if available:
                color_name, color_rgb = random.choice(available)
                shape_color_dict[shape].append(color_name)
            else:
                color_name = None
                color_rgb = (random.randint(0, 255), random.randint(0, 255),
                             random.randint(0, 255))
        else:
            if random.choice([True, False]):
                color_name, color_rgb = random.choice(list(color_list))
            else:
                color_name = None
                color_rgb = (random.randint(0, 255), random.randint(0, 255),
                             random.randint(0, 255))
            if color_name:
                shape_color_dict[shape].append(color_name)
        results[instance] = [color_name, color_rgb, shape]
    return results


def get_all_qa(
    all_corpus: Sequence[Sequence],
    shape_color_info: Dict,
    class_names: Optional[Sequence[str]],
    answer_type: str = '',
) -> Tuple[List[str], List]:
    """Render each corpus row to text, expanding instance-index lists to
    '<class> within the <color> <shape>' phrases. Returns
    (texts, instance indices in drawing order)."""
    all_text = []
    drawn_instances = []
    for corpus in all_corpus:
        text = ''
        for instance_index, instance in enumerate(corpus):
            if isinstance(instance, list):
                for object_index in range(len(instance)):
                    shape_color = shape_color_info[instance[object_index]]
                    if instance_index == 0 and object_index == 0:
                        text += 'The '
                    else:
                        text += ' the '
                    if class_names is None:
                        text += 'object'
                    elif random.random() < 0.5 and answer_type != 'direct':
                        text += random.choice(['object', 'instance'])
                    else:
                        text += class_names[instance[object_index]]
                    word1, word2 = WORDS_SHAPE[shape_color[2]]
                    text += ' ' + word1 + ' '
                    if random.random() < 0.5:
                        text += 'the '
                    if shape_color[0] is not None:
                        text += shape_color[0] + ' '
                    text += word2
                    if object_index != len(instance) - 1:
                        text += ' and'
                    drawn_instances.append(instance[object_index])
            elif isinstance(instance, str):
                text += instance
            else:
                raise TypeError(
                    f"corpus entries must be list or str, got {instance!r}"
                )
            if (instance_index != len(corpus) - 1
                    and isinstance(corpus[instance_index + 1], str)):
                if corpus[instance_index + 1] not in {
                    '.', ',', '?', '!', ':', ';'
                }:
                    text += ' '
        all_text.append(text)
    return all_text, drawn_instances


def get_question(
    question: Optional[str],
    all_choices: Sequence[str],
    use_multichoice_question: bool,
    why_question: bool = False,
    no_image: bool = False,
) -> str:
    """Wrap a question with a sampled prefix and optional lettered options."""
    if why_question:
        question_prompt = random.choice(WHY_QUESTIONS)
    else:
        image_str = '' if no_image else '<image>\n'
        question_prompt = (
            image_str + random.choice(QUESTION_PREFIXES) + question
        )
    if use_multichoice_question:
        all_options = ''
        for choice_index, choice in enumerate(all_choices):
            all_options += '(' + ANSWER_MAP[choice_index] + ') ' + choice
            if choice_index != len(all_choices) - 1:
                all_options += ' '
        question_prompt += ' ' + random.choice(OPTIONS_PREFIXES) + all_options
    return question_prompt


# --------------------------------------------------------------------------
# VCR (Visual Commonsense Reasoning)


def create_question_direct_qa(line, shape_choices, color_list):
    """VCR direct Q→A: 4-option block, single-letter answer."""
    question = [line['question']]
    answer = line['answer_choices']
    all_corpus = question + answer
    all_instance_index = get_all_instances(all_corpus)
    shape_color_info = get_color_shape(
        all_instance_index, shape_choices, color_list
    )
    class_names = line['class_names']
    question, _ = get_all_qa(
        question, shape_color_info, class_names, answer_type='direct'
    )
    question = question[0]
    answer, _ = get_all_qa(
        answer, shape_color_info, class_names, answer_type='direct'
    )
    question_prompt = '<image>\n' + build_prompt(question, answer)
    question_answer_prompt = ANSWER_MAP[line['answer_label']]
    conversations = [
        {"from": "human", "value": question_prompt},
        {"from": "gpt", "value": question_answer_prompt},
    ]
    shape_color_info = [shape_color_info[i] for i in all_instance_index]
    return shape_color_info, all_instance_index, conversations


def create_question_direct_qar(line, shape_choices, color_list):
    """VCR direct QA→R: given Q and its answer, pick the rationale."""
    question = [line['question']]
    org_answer = [line['answer_choices'][line['answer_label']]]
    why_answer = line['rationale_choices']
    all_corpus = question + org_answer + why_answer
    all_instance_index = get_all_instances(all_corpus)
    shape_color_info = get_color_shape(
        all_instance_index, shape_choices, color_list
    )
    class_names = line['class_names']
    question, _ = get_all_qa(
        question, shape_color_info, class_names, answer_type='direct'
    )
    question = question[0]
    org_answer, _ = get_all_qa(
        org_answer, shape_color_info, class_names, answer_type='direct'
    )
    org_answer = org_answer[0]
    why_answer, _ = get_all_qa(
        why_answer, shape_color_info, class_names, answer_type='direct'
    )
    question_prompt = build_prompt('', why_answer)
    why_answer_prompt = ANSWER_MAP[line['rationale_label']]
    conversations = [
        {
            "from": "human",
            "value": '<image>\n' + (
                'I give you a question and its answer, I need you to '
                'provide a rationale explaining why the answer is right. '
                f'"{question}" The answer is "{org_answer}".'
                'What is the rationale for this decision?'
                f'{question_prompt}'
            ),
        },
        {"from": "gpt", "value": why_answer_prompt},
    ]
    shape_color_info = [shape_color_info[i] for i in all_instance_index]
    return shape_color_info, all_instance_index, conversations


def create_question_prompt(line, shape_choices, color_list):
    """VCR two-turn Q→A then why→rationale, each independently free-form
    or multiple-choice."""
    use_multichoice_question = random.random() < 0.5
    use_multichoice_why = random.random() < 0.5
    question = [line['question']]
    if not use_multichoice_question:
        answer = [line['answer_choices'][line['answer_label']]]
    else:
        answer = line['answer_choices']
    if not use_multichoice_why:
        why_answer = [line['rationale_choices'][line['rationale_label']]]
    else:
        why_answer = line['rationale_choices']
    all_corpus = question + answer + why_answer
    all_instance_index = get_all_instances(all_corpus)
    shape_color_info = get_color_shape(
        all_instance_index, shape_choices, color_list
    )
    class_names = line['class_names']
    question, _ = get_all_qa(question, shape_color_info, class_names)
    question = question[0]
    answer, _ = get_all_qa(answer, shape_color_info, class_names)
    why_answer, _ = get_all_qa(why_answer, shape_color_info, class_names)

    question_prompt = get_question(
        question, answer, use_multichoice_question
    )
    answer_index = line['answer_label'] if use_multichoice_question else 0
    question_answer_prompt = get_answer(
        answer_index, answer[answer_index], use_multichoice_question
    )
    why_prompt = get_question(
        None, why_answer, use_multichoice_why, why_question=True
    )
    why_answer_index = line['rationale_label'] if use_multichoice_why else 0
    why_answer_prompt = get_answer(
        why_answer_index, why_answer[why_answer_index], use_multichoice_why
    )
    conversations = [
        {"from": "human", "value": question_prompt},
        {"from": "gpt", "value": question_answer_prompt},
        {"from": "human", "value": why_prompt},
        {"from": "gpt", "value": why_answer_prompt},
    ]
    shape_color_info = [shape_color_info[i] for i in all_instance_index]
    return shape_color_info, all_instance_index, conversations


# --------------------------------------------------------------------------
# Flickr30k Entities grounded description


def create_question_prompt_flicker30k(line, shape_choices, color_list):
    """Grounded caption with per-entity prompts; semantic or
    semantic+visual-prompt description modes. Returns
    (shape_color per drawn box, conversation, flat bbox list)."""
    describe_mode = random.choice(["semantic", "semantic_visual_prompt"])
    question = random.choice(DESCRIBE_QUESTIONS[describe_mode])

    all_instance_index = range(len(line['bbox']))
    caption = line["grounding"]
    shape_color_info = get_color_shape(
        all_instance_index, shape_choices, color_list
    )

    use_visual_prompt_hint = random.random() < 0.5
    if use_visual_prompt_hint:
        question += random.choice(
            [" Hint: the visual prompts are:", " The visual prompts are:"]
        )
        for instance_index in all_instance_index:
            shape_color = shape_color_info.get(
                instance_index, (None, None, None)
            )
            if shape_color[0] is not None:
                question += ' ' + shape_color[0]
            question += ' ' + WORDS_SHAPE[shape_color[2]][1]
            if instance_index != len(all_instance_index) - 1:
                question += ','
            if instance_index == len(all_instance_index) - 2:
                question += ' and'
        question += '.'

    def replace_bbox(match):
        idx = int(match.group(1))
        shape_color = shape_color_info.get(idx, (None, None, None))
        if idx >= len(line['bbox']):
            raise ValueError(f"<bbox{idx}> out of range in grounding caption")
        if describe_mode == "semantic":
            return ""
        # semantic_visual_prompt: unnamed (random-RGB) colors drop the
        # phrase (an empty replacement)
        if shape_color[0] is None:
            return ""
        word1, word2 = WORDS_SHAPE[shape_color[2]]
        return f" {word1} the {shape_color[0]} {word2}"

    question_answer_prompt = re.sub(r' <bbox(\d+)>', replace_bbox, caption)
    question_answer_prompt = add_period_and_autocorrect(question_answer_prompt)
    question_prompt = '<image>\n' + question

    conversations = [
        {"from": "human", "value": question_prompt},
        {"from": "gpt", "value": question_answer_prompt},
    ]
    # one overlay per box of each entity, repeating the entity's style
    shape_color_info_new = []
    bboxes_all = []
    for i in all_instance_index:
        for box in line['bbox'][i]:
            shape_color_info_new.append(shape_color_info[i])
            bboxes_all.append(box)
    return shape_color_info_new, conversations, bboxes_all


# --------------------------------------------------------------------------
# Visual7W / PointQA


def create_question_prompt_direct(line, shape_choices, color_list,
                                  answer_type: str = ''):
    """V7W 'which region' multiple choice: options are the candidate boxes
    themselves."""
    question = [[line['question']]]
    line['answer_label'] = line['bboxes'].index(line['answer'])
    answer = [[[i]] for i in range(len(line['bboxes']))]
    all_corpus = question + answer
    all_instance_index = get_all_instances(all_corpus)
    shape_color_info = get_color_shape(
        all_instance_index, shape_choices, color_list
    )
    class_names = None
    question = get_all_qa(
        question, shape_color_info, class_names, answer_type=answer_type
    )[0][0]
    answer = get_all_qa(
        answer, shape_color_info, class_names, answer_type=answer_type
    )[0]
    question_prompt = build_prompt(question, answer)
    question_answer_prompt = ANSWER_MAP[line['answer_label']]
    conversation = [
        {"from": "human", "value": '<image>\n' + question_prompt},
        {"from": "gpt", "value": question_answer_prompt},
    ]
    shape_color_info = [shape_color_info[i] for i in all_instance_index]
    bboxes_all = [line["bboxes"][i] for i in all_instance_index]
    return shape_color_info, conversation, bboxes_all


def create_question_prompt_direct_pointQA(line,
                                          question_type='general_question'):
    """PointQA-twice: fixed red rectangle on the exemplar object."""
    shape_color_info = [['red', (255, 0, 0), 'rectangle']]
    if isinstance(question_type, list):
        question_type_target = random.choice(question_type)
    else:
        question_type_target = question_type
    conversation = [
        {
            "from": "human",
            "value": '<image>\n' + line[question_type_target]
            + ' The exemplary object is within the rectangle.'
            + "\nAnswer the question using a single word or phrase.",
        },
        {"from": "gpt", "value": line['answer']},
    ]
    return shape_color_info, conversation


# --------------------------------------------------------------------------
# refcocog / vg_rel / osprey conversation templating


def vip_conv_generator(source, sampled_shapes, dataset_type, sub_type=''):
    """Build (or marker-substitute) the conversation for refcocog, vg_rel
    and osprey rows."""
    convs_source = []
    if dataset_type == 'refcocog':
        if sub_type == 'gpt4v':
            color_name, _, shape = sampled_shapes[0]
            word1, word2 = WORDS_SHAPE[shape]
            color_string = f' {color_name}' if color_name is not None else ''
            text = f'{word1} the{color_string} {word2}'
            for turn in source['conversations']:
                turn['value'] = turn['value'].replace('<bbox>', text)
            source['conversations'][0]['value'] = (
                '<image>\n' + source['conversations'][0]['value']
            )
            return source['conversations']
        if random.random() < 0.25:
            prompt = random.choice([
                'Describe the object with the visual prompt.',
                'Describe the pointed region.',
            ])
        else:
            prompt = 'Describe the object .'
        prompt += ' Please provide a short phrase.'
        convs_source.append([prompt, source['answer']])
    elif dataset_type == 'vg_rel':
        if sub_type == 'gpt4v':
            for bbox_index, (color_name, _, shape) in enumerate(
                sampled_shapes
            ):
                word1, word2 = WORDS_SHAPE[shape]
                text = word1 + ' '
                if random.random() < 0.5:
                    text += 'the '
                if color_name is not None:
                    text += color_name + ' '
                text += word2
                for turn in source['conversations']:
                    turn['value'] = turn['value'].replace(
                        f'<bbox{bbox_index}>', text
                    )
            return source['conversations']
        prompts = []
        for color_name, _, shape in sampled_shapes:
            word1, word2 = WORDS_SHAPE[shape]
            color_string = f' {color_name}' if color_name is not None else ''
            prompts.append(f'{word1} the{color_string} {word2}')
        prompt = (
            f"Please describe the relationship between the subject "
            f"{prompts[0]} and the object {prompts[1]}. Provide a short "
            f"triplet (subject, relationship, object) to represent this. "
            f"Here, the subject and object are noun phrases, and the "
            f"relationship can be verbs or prepositions."
        )
        convs_source.append([prompt, source['answer']])
    elif dataset_type == 'osprey':
        for bbox_index, (color_name, _, shape) in enumerate(sampled_shapes):
            _, word2 = WORDS_SHAPE[shape]
            text = 'the '
            if color_name is not None:
                text += color_name + ' '
            text += word2
            for turn in source['conversations']:
                # the digit is optional in the pattern
                turn['value'] = re.sub(
                    fr'<reg(in|ion){bbox_index + 1}?>', text, turn['value']
                )
        return source['conversations']
    else:
        raise KeyError(
            f"vip_conv_generator: unknown dataset type {dataset_type!r}"
        )

    conv = []
    for human_conv, gpt_conv in convs_source:
        conv.extend([
            {"from": "human", "value": human_conv},
            {"from": "gpt", "value": gpt_conv},
        ])
    return conv
